"""The port's Adafactor and int8 error-feedback compression on the CPU,
against the reference (``repro.optim.adafactor``, ``.compression``).

Tolerances, and why:

* Adafactor fed identical gradients: the same float32 operations in the
  same order, up to the order of each mean's sum (XLA's reduction against
  torch's): updates and state at rtol 1e-5 / atol 1e-6 * max;
* the int8 codes and scales: exactly equal (the same max, one IEEE
  division and round half to even in both), the residuals within
  1e-6 * the scale (a product and a difference, both exact but for the
  last bit);
* the reference's own bounds where a test mirrors one of its tests
  (``tests/test_substrates.py``, ``tests/test_compression_lowering.py``).
"""

import os
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro import configs as jcfgs
from repro.models import init_params as jinit
from repro.optim import adafactor as jadafactor
from repro.optim import ef_compress as jef_compress
from repro.optim import ef_decompress as jef_decompress
from repro.optim import ef_init as jef_init
from repro.optim import ef_scale as jef_scale
from repro_torch import configs as tcfgs
from repro_torch.convert import (adafactor_state_from_numpy,
                                 lm_params_from_numpy)
from repro_torch.models.params import leaves, map_tree
from repro_torch.optim import (adafactor, apply_updates, ef_compress,
                               ef_decompress, ef_init, ef_scale)

ADA = dict(rtol=1e-5)


def _np(x):
    return np.asarray(x, np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


# --- Adafactor ----------------------------------------------------------------


def _quadratic_steps(opt, steps):
    target = torch.tensor([1.0, -2.0, 3.0])
    params = {"w": torch.zeros(3)}
    state = opt.init(params)
    for i in range(steps):
        w = params["w"].clone().requires_grad_()
        (g,) = torch.autograd.grad(torch.sum((w - target) ** 2), [w])
        ups, state, _ = opt.update({"w": g}, state, params, i)
        params = apply_updates(params, ups)
    return float(torch.sum((params["w"] - target) ** 2))


def test_adafactor_converges_quadratic():
    """``tests/test_substrates.py``: momentum-free Adafactor rings near the
    optimum; 0.5 from a start error of 14.0 is converged."""
    assert _quadratic_steps(adafactor(0.5), steps=200) < 0.5


def test_adafactor_state_is_factored():
    opt = adafactor(1e-3)
    params = {"big": torch.zeros((256, 512)), "small": torch.zeros((4, 4)),
              "edge": torch.zeros((127, 512)), "stacked": torch.zeros(
                  (3, 128, 130))}
    st = opt.init(params)
    assert st["v"]["big"]["vr"].shape == (256,)
    assert st["v"]["big"]["vc"].shape == (512,)
    assert st["v"]["small"]["v"].shape == (4, 4)
    assert set(st["v"]["edge"]) == {"v"}          # 127 < 128: not factored
    assert st["v"]["stacked"]["vr"].shape == (3, 128)
    assert st["v"]["stacked"]["vc"].shape == (3, 130)
    assert all(t.dtype == torch.float32 for _, t in leaves(st))


_SHAPES = {"big": (256, 300), "vec": (40,), "small": (8, 6),
           "stacked": (2, 128, 160)}


def _tree(rng, scale=1.0):
    return {k: (scale * rng.standard_normal(sh)).astype(np.float32)
            for k, sh in _SHAPES.items()}


@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
@pytest.mark.parametrize("lr_kind", ["const", "schedule"])
def test_adafactor_updates_match_reference(weight_decay, lr_kind):
    """Four steps on the same gradients (factored 2-D and stacked 3-D
    leaves, an unfactored vector and a small matrix; one step's
    gradients large enough that update clipping binds): updates, state
    and parameters as the reference's."""
    rng = np.random.default_rng(3)
    params = _tree(rng)
    lr = 0.01 if lr_kind == "const" else (lambda s: 0.01 / (1.0 + s))
    jopt = jadafactor(lr, weight_decay=weight_decay)
    topt = adafactor(lr, weight_decay=weight_decay)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: _t(v) for k, v in params.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(4):
        g = _tree(rng, scale=100.0 if step == 2 else 1e-2)
        ju, js, jm = jopt.update({k: jnp.asarray(v) for k, v in g.items()},
                                 js, jp, jnp.asarray(step))
        tu, ts, tm = topt.update({k: _t(v) for k, v in g.items()}, ts, tp,
                                 step)
        assert tm["lr"] == pytest.approx(float(jm["lr"]), rel=1e-7)
        for k in _SHAPES:
            w = _np(ju[k])
            np.testing.assert_allclose(tu[k].numpy(), w, atol=1e-6 * float(
                np.abs(w).max()), err_msg=k, **ADA)
            for n, sv in js["v"][k].items():
                w = _np(sv)
                np.testing.assert_allclose(
                    ts["v"][k][n].numpy(), w,
                    atol=1e-6 * float(np.abs(w).max()), err_msg=f"{k}/{n}",
                    **ADA)
        jp = jax.tree_util.tree_map(lambda a, b: a + b, jp, ju)
        tp = apply_updates(tp, tu)
    for k in _SHAPES:
        np.testing.assert_allclose(tp[k].numpy(), _np(jp[k]), rtol=1e-5,
                                   atol=1e-6)


def test_adafactor_update_rms_is_clipped():
    """A huge gradient's update has RMS lr * clip_threshold at most."""
    opt = adafactor(1.0, clip_threshold=1.0)
    p = {"w": torch.zeros(300, 200)}
    g = {"w": torch.full((300, 200), 1e6)}
    u, _, _ = opt.update(g, opt.init(p), p, 0)
    assert float(torch.sqrt(torch.mean(u["w"] ** 2))) <= 1.0 + 1e-6


def test_adafactor_state_from_numpy_resumes_the_reference():
    """The reference's Adafactor state over a smoke LM's parameters,
    carried over, continues as the reference's does: one more step gives
    the reference's updates."""
    jcfg = jcfgs.get_smoke_config("recurrentgemma-9b")
    tcfg = tcfgs.get_smoke_config("recurrentgemma-9b")
    jp = jinit(jcfg, jax.random.PRNGKey(0))
    np_p = jax.tree_util.tree_map(np.asarray, jp)
    tp = lm_params_from_numpy(np_p, tcfg, device="cpu")
    rng = np.random.default_rng(4)
    grads = jax.tree_util.tree_map(
        lambda a: (1e-2 * rng.standard_normal(a.shape)).astype(np.float32),
        np_p)
    # factored leaves exist at this size only with a smaller threshold
    jopt, topt = (f(1e-3, min_dim_size_to_factor=32)
                  for f in (jadafactor, adafactor))
    js = jopt.init(jp)
    _, js, _ = jopt.update(jax.tree_util.tree_map(jnp.asarray, grads), js,
                           jp, jnp.asarray(0))
    ts = adafactor_state_from_numpy(jax.tree_util.tree_map(np.asarray, js),
                                    tcfg, device="cpu",
                                    min_dim_size_to_factor=32)
    assert any(path[-1] == "vr" for path, _ in leaves(ts))
    ju, _, _ = jopt.update(jax.tree_util.tree_map(jnp.asarray, grads), js,
                           jp, jnp.asarray(1))
    tu, _, _ = topt.update(map_tree(_t, grads), ts, tp, 1)
    want = dict(leaves(jax.tree_util.tree_map(np.asarray, ju)))
    for path, t in leaves(tu):
        w = want[path]
        np.testing.assert_allclose(t.numpy(), w, atol=1e-6 * float(
            np.abs(w).max()), err_msg="/".join(path), **ADA)
    with pytest.raises(ValueError, match="expected keys"):
        adafactor_state_from_numpy(jax.tree_util.tree_map(np.asarray, js),
                                   tcfg, device="cpu")   # factored at 128
    with pytest.raises(ValueError, match="expected keys"):
        adafactor_state_from_numpy({"m": {}}, tcfg, device="cpu")


# --- error-feedback compression ----------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 7, 12345, 2 ** 31 - 1])
def test_ef_compression_error_feedback_reduces_bias(seed):
    """``tests/test_substrates.py``: after 20 rounds of the same gradient
    the mean of what was sent is the gradient (the residual stays
    bounded), at its atol 0.02."""
    g = {"w": _t(np.random.default_rng(seed).standard_normal(64))}
    res = ef_init(g)
    total = torch.zeros(64)
    for _ in range(20):
        q, scale, res = ef_compress(g, res)
        total = total + ef_decompress(q, scale)["w"]
    np.testing.assert_allclose((total / 20).numpy(), g["w"].numpy(),
                               atol=0.02)


def test_ef_compression_wire_dtype():
    g = {"w": torch.linspace(-3, 3, 128)}
    q, scale, res = ef_compress(g, ef_init(g))
    assert q["w"].dtype == torch.int8                  # 4x smaller than f32
    rec = ef_decompress(q, scale)["w"]
    assert float(torch.max(torch.abs(rec - g["w"]))) < 3.0 / 127 + 1e-6


@pytest.mark.parametrize("shared_scale", [False, True])
def test_ef_compress_matches_reference(shared_scale):
    """Three rounds on the same gradients (a bf16 leaf among them, and
    values that sit exactly halfway between two codes): int8 codes and
    scales equal, residuals and decompressed values within 1e-6 * scale."""
    rng = np.random.default_rng(9)
    grads = {"a": rng.standard_normal((33, 17)).astype(np.float32),
             "b": np.array([-1.5, -0.5, 0.5, 1.5, 2.5, 127.0, 0.0],
                           np.float32),
             "z": np.zeros(5, np.float32)}
    jg = {k: jnp.asarray(v) for k, v in grads.items()}
    tg = {k: _t(v) for k, v in grads.items()}
    jg["h"] = jnp.asarray(grads["a"][:4], jnp.bfloat16)
    tg["h"] = _t(grads["a"][:4]).to(torch.bfloat16)
    jr, tr = jef_init(jg), ef_init(tg)
    for _ in range(3):
        js = jef_scale(jg, jr) if shared_scale else None
        ts = ef_scale(tg, tr) if shared_scale else None
        jq, jsc, jr = jef_compress(jg, jr, scale=js)
        tq, tsc, tr = ef_compress(tg, tr, scale=ts)
        jd, td = jef_decompress(jq, jsc), ef_decompress(tq, tsc)
        for k in jg:
            sc = float(jsc[k])
            assert float(tsc[k]) == sc, k
            assert tq[k].dtype == torch.int8
            np.testing.assert_array_equal(tq[k].numpy(), np.asarray(jq[k]),
                                          err_msg=k)
            for got, want in ((tr[k], jr[k]), (td[k], jd[k])):
                np.testing.assert_allclose(got.numpy(), _np(want), rtol=0,
                                           atol=1e-6 * sc, err_msg=k)
    # an all-zero gradient quantizes on the floor scale, to zeros
    assert float(tsc["z"]) == pytest.approx(1e-20 / 127, rel=1e-6)
    assert not tq["z"].any()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _allreduce_worker(rank, port, out_dir):
    """One of 4 ranks of a (pod 2, data 2) grid, rank = 2 * pod + data,
    as the reference's test lays its mesh out: the shard of (8, 64) at
    rows 4 * pod, columns 32 * data."""
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=4, rank=rank)
    try:
        pod, data = divmod(rank, 2)
        pods = [dist.new_group([0, 2]), dist.new_group([1, 3])]
        datas = [dist.new_group([0, 1]), dist.new_group([2, 3])]
        g_global = torch.from_numpy(np.random.default_rng(0).standard_normal(
            (8, 64)).astype(np.float32))
        mine = g_global[4 * pod:4 * pod + 4, 32 * data:32 * data + 32]
        pod_group, data_group = pods[data], datas[pod]

        def compressed_pod_allreduce(g, res):
            g = g.clone()
            dist.all_reduce(g, group=data_group)
            g = g / 2
            scale = ef_scale({"g": g}, {"g": res})
            dist.all_reduce(scale["g"], op=dist.ReduceOp.MAX,
                            group=pod_group)
            q, scale, res_d = ef_compress({"g": g}, {"g": res}, scale=scale)
            wire = q["g"].to(torch.int32)      # |sum| <= 254
            dist.all_reduce(wire, group=pod_group)
            return wire.to(torch.float32) * scale["g"] / 2, res_d["g"], \
                q["g"].dtype, wire.dtype

        r = torch.zeros_like(mine)
        tot = torch.zeros_like(mine)
        for _ in range(10):
            o, r, qdt, wdt = compressed_pod_allreduce(mine, r)
            tot = tot + o
        true = mine.clone()
        dist.all_reduce(true)
        true = true / 4
        drift = float(torch.max(torch.abs(tot / 10 - true)))
        torch.save({"drift": drift, "q": str(qdt), "wire": str(wdt)},
                   os.path.join(out_dir, f"{rank}.pt"))
    finally:
        dist.destroy_process_group()


def test_int8_cross_pod_allreduce(tmp_path):
    """``tests/test_compression_lowering.py`` on 4 CPU processes
    (``torch.distributed``, gloo): the data-mean, then an int8 round over
    the pod link with the scale max-shared across pods; over 10 rounds
    with error feedback the mean of what arrived is the true mean within
    the reference's 0.15, and the payload is int8 codes summed as
    integers."""
    mp.spawn(_allreduce_worker, args=(_free_port(), str(tmp_path)),
             nprocs=4, join=True)
    outs = [torch.load(tmp_path / f"{r}.pt") for r in range(4)]
    for out in outs:
        assert out["drift"] < 0.15, out
        assert out["q"] == "torch.int8" and out["wire"] == "torch.int32"
