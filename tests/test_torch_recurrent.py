"""The port's recurrent families on the CPU, against the reference.

RG-LRU (recurrentgemma-9b's hybrid blocks), mLSTM and sLSTM (xlstm-125m)
in ``repro_torch.models.recurrent``, ``causal_conv1d``, the two configs'
``LM`` (the ring cache, loss and gradients; their configs, parameter
counts, prefill, decode and greedy serving are among the archs of
``test_torch_models.py``), the serving engine on the hybrid past its
window, the remat switches and the two example twins.  The reference's
``init_params`` tree is carried over with ``convert.lm_params_from_numpy``
and both packages get the same inputs, drawn with numpy from a seed.
Tolerances, and why:

* float32 (``dtype="float32"``): the packages sum the same products in
  other orders (XLA's and torch's CPU matmuls; a combine of the scan XLA
  may fuse into one FMA), so outputs and logits are held to rtol 1e-4 /
  atol 1e-5, the loss to rtol 1e-5 and each gradient leaf to
  1e-4 * max|g| of ``jax.grad``'s, as ``test_torch_train.py`` holds the
  dense models;
* greedy tokens: exactly equal (the engines in float32, as
  ``test_torch_models.py`` explains);
* the remat settings: the same operations on the same inputs, so losses
  and gradients are bit-equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro import configs as jcfgs
from repro.models import LM as JLM
from repro.models import init_params as jinit
from repro.models import layers as jlayers
from repro.models import recurrent as jrec
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JEngine
from repro_torch import configs as tcfgs
from repro_torch.convert import lm_params_from_numpy
from repro_torch.examples import serve_lm, train_lm
from repro_torch.models import (LM, compute_params, init_params,
                                param_counts)
from repro_torch.models import layers as tlayers
from repro_torch.models import recurrent as trec
from repro_torch.models.params import leaves
from repro_torch.serving import Request, ServingEngine
from repro_torch.train import loss_and_grads

ARCHS = ["recurrentgemma-9b", "xlstm-125m"]
F32 = dict(rtol=1e-4, atol=1e-5)


def _cfgs(arch, **overrides):
    j = dataclasses.replace(jcfgs.get_smoke_config(arch), **overrides)
    t = dataclasses.replace(tcfgs.get_smoke_config(arch), **overrides)
    return j, t


def _pair(arch, seed=0, **overrides):
    jcfg, tcfg = _cfgs(arch, **overrides)
    jp = jinit(jcfg, jax.random.PRNGKey(seed))
    tp = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                              device="cpu")
    return (jcfg, jp), (tcfg, tp)


def _np(x):
    return np.asarray(x, np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def _block_params(arch, key, kind, **overrides):
    """(reference cfg, port cfg, the reference's and the port's params of
    layer 0 of stacked block ``key``'s ``kind`` sub-tree)."""
    (jcfg, jp), (tcfg, tp) = _pair(arch, **overrides)
    jb = jax.tree_util.tree_map(lambda a: a[0], jp["stack"][key][kind])
    tb = {k: v[0] for k, v in tp["stack"][key][kind].items()}
    return jcfg, tcfg, jb, tb


def _close_state(got: dict, want: dict, tol=F32):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].float().numpy(), _np(want[k]),
                                   err_msg=k, **tol)


# --- configs, params ---------------------------------------------------------------


def test_full_configs_build():
    """``LM`` of both full configs builds, and their sizes are the
    published ones: recurrentgemma-9b ~10.4e9 with its untied 256k
    tables, xlstm-125m 196M with embeddings (``examples/train_lm.py``)."""
    for arch, want in (("recurrentgemma-9b", 10.4e9), ("xlstm-125m", 196e6)):
        cfg = tcfgs.get_config(arch)
        LM(cfg)
        total, active = param_counts(cfg)
        assert total == active and abs(total - want) / want < 0.05, arch


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_shapes_and_lru_lambda(arch):
    cfg = tcfgs.get_smoke_config(arch)
    a = init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    jp = jinit(jcfgs.get_smoke_config(arch), jax.random.PRNGKey(0))
    shapes = jax.tree_util.tree_map(lambda x: tuple(x.shape), jp)
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), a) == shapes
    if arch == "recurrentgemma-9b":
        # a = exp(-8 softplus(lam)) lies in [0.9, 0.999] at init
        lam = a["stack"]["0_rglru"]["rglru"]["lam"]
        alpha = torch.exp(-8.0 * torch.nn.functional.softplus(lam))
        assert float(alpha.min()) >= 0.9 - 1e-6
        assert float(alpha.max()) <= 0.999 + 1e-6


def test_compute_params_casts_recurrent_weights_but_lam():
    cfg = tcfgs.get_smoke_config("recurrentgemma-9b")
    c = compute_params(cfg, init_params(cfg, device="cpu"))
    blk = c["stack"]["0_rglru"]["rglru"]
    assert blk["w_a"].dtype == blk["conv_w"].dtype == torch.bfloat16
    assert blk["lam"].dtype == torch.float32
    cfg = tcfgs.get_smoke_config("xlstm-125m")
    c = compute_params(cfg, init_params(cfg, device="cpu"))
    assert c["stack"]["0_mlstm"]["mlstm"]["w_if"].dtype == torch.bfloat16
    assert c["stack"]["1_slstm"]["slstm"]["r_z"].dtype == torch.bfloat16
    assert c["stack"]["1_slstm"]["ln2"].dtype == torch.float32


# --- layers ----------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv1d_matches_reference(k, with_state):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 6)).astype(np.float32)
    w = rng.standard_normal((k, 6)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    st = (rng.standard_normal((2, k - 1, 6)).astype(np.float32)
          if with_state else None)
    jo, js = jlayers.causal_conv1d(jnp.asarray(x), jnp.asarray(w),
                                   jnp.asarray(b),
                                   None if st is None else jnp.asarray(st))
    to, ts = tlayers.causal_conv1d(_t(x), _t(w), _t(b),
                                   None if st is None else _t(st))
    np.testing.assert_allclose(to.numpy(), _np(jo), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(ts.numpy(), _np(js))
    assert ts.shape == (2, k - 1, 6)


@pytest.mark.parametrize("n", [1, 2, 5, 8, 13, 64])
def test_associative_scan_matches_reference(n):
    rng = np.random.default_rng(n)
    a = rng.uniform(0.5, 1.0, (2, n, 3)).astype(np.float32)
    b = rng.standard_normal((2, n, 3)).astype(np.float32)

    def combine(e1, e2):
        return e1[0] * e2[0], e2[0] * e1[1] + e2[1]

    ja, jh = jax.lax.associative_scan(combine, (jnp.asarray(a),
                                                jnp.asarray(b)), axis=1)
    ta, th = trec.associative_scan(_t(a), _t(b))
    np.testing.assert_allclose(th.numpy(), _np(jh), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ta.numpy(), _np(ja), rtol=1e-6, atol=1e-6)
    # and it is the linear recurrence
    h, want = np.zeros((2, 3), np.float32), []
    for t in range(n):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    np.testing.assert_allclose(th.numpy(), np.stack(want, 1), rtol=1e-5,
                               atol=1e-5)


def test_rglru_scan_is_log_depth(monkeypatch):
    """A 4096-step scan is 2 log2(4096) batched combines, not a loop over
    the sequence; its combines multiply the reference's count of
    elements (each level halves the sequence)."""
    calls = []
    real = trec._combine
    monkeypatch.setattr(trec, "_combine", lambda *e: calls.append(
        e[0].shape[1]) or real(*e))
    a = torch.rand(1, 4096, 2)
    trec.associative_scan(a, torch.rand(1, 4096, 2))
    assert len(calls) == 2 * 12
    assert sum(calls) == 2 * (4096 - 1) - 12


def _x(shape, seed=2):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_rglru_full_and_decode_match_reference():
    jcfg, tcfg, jb, tb = _block_params("recurrentgemma-9b", "0_rglru",
                                       "rglru", dtype="float32")
    x = _x((2, 9, 64))
    jo, jst = jrec.rglru_full(jcfg, jb, jnp.asarray(x), return_state=True)
    to, tst = trec.rglru_full(tcfg, tb, _t(x), return_state=True)
    np.testing.assert_allclose(to.numpy(), _np(jo), **F32)
    _close_state(tst, jst)
    x1 = _x((2, 1, 64), seed=3)
    jo, jst = jrec.rglru_decode(jcfg, jb, jnp.asarray(x1), jst)
    to, tst = trec.rglru_decode(tcfg, tb, _t(x1), tst)
    np.testing.assert_allclose(to.numpy(), _np(jo), **F32)
    _close_state(tst, jst)
    z = trec.init_rglru_state(tcfg, 3, device="cpu")
    jz = jrec.init_rglru_state(jcfg, 3)
    assert {k: tuple(v.shape) for k, v in z.items()} == \
        {k: tuple(v.shape) for k, v in jz.items()}


def test_mlstm_full_and_decode_match_reference():
    jcfg, tcfg, jb, tb = _block_params("xlstm-125m", "0_mlstm", "mlstm",
                                       dtype="float32")
    x = _x((2, 9, 64))
    jo, jst = jrec.mlstm_full(jcfg, jb, jnp.asarray(x), return_state=True)
    to, tst = trec.mlstm_full(tcfg, tb, _t(x), return_state=True)
    np.testing.assert_allclose(to.numpy(), _np(jo), **F32)
    _close_state(tst, jst)
    for i in range(2):
        x1 = _x((2, 1, 64), seed=4 + i)
        jo, jst = jrec.mlstm_decode(jcfg, jb, jnp.asarray(x1), jst)
        to, tst = trec.mlstm_decode(tcfg, tb, _t(x1), tst)
        np.testing.assert_allclose(to.numpy(), _np(jo), **F32)
        _close_state(tst, jst)
    z = trec.init_mlstm_state(tcfg, 2, device="cpu")
    assert float(z["m"].max()) == float(np.float32(-1e30))
    assert z["c"].dtype == torch.float32


def test_slstm_full_decode_and_ffn_match_reference():
    jcfg, tcfg, jb, tb = _block_params("xlstm-125m", "1_slstm", "slstm",
                                       dtype="float32")
    x = _x((2, 9, 64))
    jo, jst = jrec.slstm_full(jcfg, jb, jnp.asarray(x), return_state=True)
    to, tst = trec.slstm_full(tcfg, tb, _t(x), return_state=True)
    np.testing.assert_allclose(to.numpy(), _np(jo), **F32)
    _close_state(tst, jst)
    x1 = _x((2, 1, 64), seed=5)
    jo, jst = jrec.slstm_decode(jcfg, jb, jnp.asarray(x1), jst)
    to, tst = trec.slstm_decode(tcfg, tb, _t(x1), tst)
    np.testing.assert_allclose(to.numpy(), _np(jo), **F32)
    _close_state(tst, jst)
    np.testing.assert_allclose(
        trec.slstm_ffn(tb, _t(x)).numpy(),
        _np(jrec.slstm_ffn(jb, jnp.asarray(x))), **F32)
    z = trec.init_slstm_state(tcfg, 2, device="cpu")
    assert len({t.data_ptr() for t in z.values()}) == 4   # no shared leaves


# --- LM: prefill, decode, loss ------------------------------------------------------


def test_long_window_ring_cache():
    """Windowed decode far past the window: the ring stays O(window) and
    decode matches the full forward (``tests/test_models.py``'s test, in
    the port, against the reference's logits too)."""
    (jcfg, jp), (tcfg, tp) = _pair("recurrentgemma-9b", dtype="float32")
    b, s = 1, 24                                   # 3x the window of 8
    toks = np.random.default_rng(1).integers(0, 100, (b, s + 4))
    model, cp = LM(tcfg), compute_params(tcfg, tp)
    cache, _ = model.prefill(cp, {"tokens": torch.from_numpy(toks[:, :s])},
                             max_len=s + 8)
    k_shapes = [t.shape for path, t in leaves(cache) if path[-1] == "k"]
    assert k_shapes and all(sh[-2] == tcfg.local_window for sh in k_shapes)
    for i in range(3):
        lg, cache = model.decode_step(
            cp, cache, torch.from_numpy(toks[:, s + i][:, None]))
    _, full = model.prefill(cp, {"tokens": torch.from_numpy(
        toks[:, :s + 3])}, max_len=s + 8)
    np.testing.assert_allclose(lg.numpy(), full.numpy(), **F32)
    jm = JLM(jcfg)
    _, jfull = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :s + 3])},
                          max_len=s + 8)
    np.testing.assert_allclose(lg.numpy(), _np(jfull), **F32)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_grads_match_reference(arch):
    (jcfg, jp), (tcfg, tp) = _pair(arch, dtype="float32")
    toks = np.random.default_rng(11).integers(0, tcfg.vocab_size, (2, 17))
    labels = toks[:, 1:].copy()
    labels[:, :2] = -1
    jb = {"tokens": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.from_numpy(toks[:, :-1]),
          "labels": torch.from_numpy(labels)}
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: JLM(jcfg).loss(p, jb), has_aux=True))(jp)
    tl, _, tg = loss_and_grads(LM(tcfg), tp, tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    want = dict(leaves(jax.tree_util.tree_map(np.asarray, jg)))
    got = dict(leaves(tg))
    assert got.keys() == want.keys()
    # the mLSTM's and sLSTM's input-gate biases have a gradient of
    # exactly 0 (a shift of the input gate at every step moves the
    # stabilizer m by as much and leaves C, n and h as they are): theirs
    # is float32 round-off (~1e-9 against ~1e-2 elsewhere), so every leaf
    # is also allowed 1e-6 of the largest gradient
    floor = 1e-6 * max(float(np.abs(w).max()) for w in want.values())
    for path, w in want.items():
        top = float(np.abs(w).max())
        np.testing.assert_allclose(got[path].numpy(), w, rtol=0,
                                   atol=max(1e-4 * top, floor),
                                   err_msg="/".join(path))


# --- the remat switches -------------------------------------------------------------


_REMAT = {"full": {}, "dots": {"REPRO_REMAT_POLICY": "dots"},
          "group2": {"REPRO_REMAT_GROUP": "2"}}


def _grads_under(monkeypatch, setting, cfg, params, batch):
    for k in ("REPRO_REMAT_POLICY", "REPRO_REMAT_GROUP"):
        monkeypatch.delenv(k, raising=False)
    for k, v in _REMAT[setting].items():
        monkeypatch.setenv(k, v)
    return loss_and_grads(LM(cfg), params, batch)


@pytest.mark.parametrize("arch,layers", [("xlstm-125m", 4),
                                         ("recurrentgemma-9b", 6)])
@pytest.mark.parametrize("setting", ["dots", "group2"])
def test_remat_settings_give_equal_gradients(monkeypatch, arch, layers,
                                             setting):
    """Each switch recomputes other work, never other numbers: loss and
    every gradient leaf bit-equal to "full" (two super-blocks, so that a
    group of 2 divides them)."""
    cfg = dataclasses.replace(tcfgs.get_smoke_config(arch), n_layers=layers)
    assert cfg.layer_plan().n_super == 2
    params = init_params(cfg, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 16)))
    batch = {"tokens": toks, "labels": toks}
    l0, _, g0 = _grads_under(monkeypatch, "full", cfg, params, batch)
    l1, _, g1 = _grads_under(monkeypatch, setting, cfg, params, batch)
    assert float(l1) == float(l0)
    for (path, a), (_, b) in zip(leaves(g0), leaves(g1)):
        assert torch.equal(a, b), "/".join(path)


class _CountMM(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.mm += 1
        return func(*args, **(kwargs or {}))


def _backward_mm(monkeypatch, cfg, setting):
    """Matmuls (``aten.mm`` / ``aten.addmm``) the backward of one loss
    runs under remat ``setting`` (None: no remat)."""
    for k in ("REPRO_REMAT_POLICY", "REPRO_REMAT_GROUP"):
        monkeypatch.delenv(k, raising=False)
    for k, v in _REMAT.get(setting, {}).items():
        monkeypatch.setenv(k, v)
    params = init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    for _, p in leaves(params):
        p.requires_grad_()
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 16)))
    loss, _ = LM(cfg).loss(params, {"tokens": toks, "labels": toks},
                           remat=setting is not None)
    mode = _CountMM()
    with mode:
        loss.backward()
    return mode.mm


def test_dots_policy_saves_the_matmuls(monkeypatch):
    """Under "dots" the backward reruns no forward matmul of the stacked
    blocks (their outputs were saved): it runs as many as without remat;
    under "full" it reruns them."""
    cfg = tcfgs.get_smoke_config("xlstm-125m")
    plain = _backward_mm(monkeypatch, cfg, None)
    assert _backward_mm(monkeypatch, cfg, "dots") == plain
    assert _backward_mm(monkeypatch, cfg, "full") > plain


# --- serving -------------------------------------------------------------------------


def test_serving_matches_reference_engine_with_ring_wrap():
    """The port's engine gives the reference engine's greedy tokens on the
    smoke recurrentgemma (window 8): prompts of 5-13 tokens and 10 new
    tokens each, so that lanes decode past the window and wrap the ring;
    3 requests on 2 slots, so that a freed lane takes a new request."""
    (jcfg, jp), (tcfg, tp) = _pair("recurrentgemma-9b", dtype="float32")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 100, n).tolist() for n in (13, 5, 9)]
    new = 10
    jeng = JEngine(jcfg, jp, batch_slots=2, max_len=32)
    teng = ServingEngine(tcfg, tp, batch_slots=2, max_len=32)
    for rid, pr in enumerate(prompts):
        jeng.submit(JRequest(rid=rid, prompt=pr, max_new_tokens=new))
        teng.submit(Request(rid=rid, prompt=pr, max_new_tokens=new))
    jdone = sorted(jeng.run_to_completion(), key=lambda r: r.rid)
    tdone = sorted(teng.run_to_completion(), key=lambda r: r.rid)
    assert [r.out_tokens for r in tdone] == [r.out_tokens for r in jdone]
    assert all(len(r.out_tokens) == new for r in tdone)


@pytest.mark.parametrize("arch", ARCHS)
def test_freed_lane_starts_the_next_request_from_its_own_state(arch):
    """A request admitted into the lane a finished one freed gets the
    tokens it gets alone in a fresh engine: the splice overwrote every
    recurrent state leaf of the lane."""
    cfg = dataclasses.replace(tcfgs.get_smoke_config(arch), dtype="float32")
    params = init_params(cfg, device="cpu")
    first, second = [5, 9, 2, 7, 1, 3], [11, 3, 8]

    def serve(prompts, new):
        eng = ServingEngine(cfg, params, batch_slots=1, max_len=48)
        for rid, (pr, n) in enumerate(zip(prompts, new)):
            eng.submit(Request(rid=rid, prompt=pr, max_new_tokens=n))
        return sorted(eng.run_to_completion(), key=lambda r: r.rid)

    both = serve([first, second], [12, 6])
    alone = serve([second], [6])
    assert both[1].out_tokens == alone[0].out_tokens


# --- the examples ----------------------------------------------------------------------


def test_serve_lm_twin_matches_reference_engine(capsys):
    """The twin's traffic (10 requests, 4 slots of 96) gives the
    reference engine's tokens on the same weights (float32); its main
    runs the smoke config as the reference's example does."""
    (jcfg, jp), (tcfg, tp) = _pair("recurrentgemma-9b", dtype="float32")
    done, _ = serve_lm.serve("cpu", cfg=tcfg, params=tp)
    jeng = JEngine(jcfg, jp, batch_slots=serve_lm.SLOTS,
                   max_len=serve_lm.MAX_LEN)
    for rid, pr in enumerate(serve_lm.prompts(jcfg.vocab_size)):
        jeng.submit(JRequest(rid=rid, prompt=pr,
                             max_new_tokens=serve_lm.NEW_TOKENS))
    jdone = sorted(jeng.run_to_completion(), key=lambda r: r.rid)
    assert [r.out_tokens for r in done] == [r.out_tokens for r in jdone]
    out = serve_lm.main(["--device", "cpu"])
    assert [r.rid for r in out] == list(range(10))
    assert all(len(r.out_tokens) == 10 for r in out)
    assert "10 requests / 100 tokens" in capsys.readouterr().out


def test_train_lm_twin_reduces_loss_and_checkpoints(tmp_path, capsys):
    losses = train_lm.main(["--device", "cpu", "--smoke", "--steps", "20",
                            "--batch", "8", "--seq", "32", "--ckpt-dir",
                            str(tmp_path)])
    assert losses[-1] < losses[0] and len(losses) == 3   # steps 0, 10, 19
    assert any(tmp_path.iterdir())
    assert "loss:" in capsys.readouterr().out


def test_examples_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        serve_lm.main([])
    with pytest.raises(RuntimeError, match="no CUDA card"):
        train_lm.main(["--steps", "1", "--ckpt-dir", ""])
