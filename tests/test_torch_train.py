"""The port's training path on the CPU, against the reference.

The reference's ``init_params`` tree is carried over with
``convert.lm_params_from_numpy`` and both packages get the same tokens,
drawn once with numpy (``jax.random`` and ``torch.Generator`` give
different streams, so neither package's data task feeds the other).
Tolerances, and why:

* ``LM.loss`` and ``chunked_ce_loss`` in float32 (``dtype="float32"``):
  the packages sum the same products in other orders (XLA's and torch's
  CPU matmuls; a chunked softmax against a dense one inside attention),
  so the loss is held to rtol 1e-5 and each gradient leaf to
  1e-4 * max|g| of the reference's ``jax.grad``;
* the optimizer and schedule fed identical gradients: the same float32
  operations in the same order, up to the last bits of the global norm's
  sum and of pow/cos: rtol 1e-6;
* the Markov transition table: bit-equal (the same numpy draws);
* the 60-step run: ``tests/test_system.py``'s own criteria (a drop of
  more than 1.0 nats, and not below the entropy floor minus 0.2);
* checkpoints and the fault-tolerant runner: bit-equal, as the
  reference's own tests demand.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfgs
from repro.checkpoint import CheckpointManager as JManager
from repro.data import MarkovTask as JMarkov
from repro.models import LM as JLM
from repro.models import init_params as jinit
from repro.models import layers as jlayers
from repro.optim import adamw as jadamw
from repro.optim import global_norm_clip as jclip
from repro.optim import warmup_cosine as jcosine
from repro.train import make_train_step as jmake_train_step
from repro_torch import configs as tcfgs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.convert import adamw_state_from_numpy, lm_params_from_numpy
from repro_torch.data import MarkovTask, SyntheticTask
from repro_torch.distributed.fault import FaultTolerantRunner
from repro_torch.launch import train as ttrain
from repro_torch.models import LM, init_params
from repro_torch.models import layers as tlayers
from repro_torch.models.params import leaves, map_tree
from repro_torch.optim import (adamw, apply_updates, global_norm_clip,
                               warmup_cosine)
from repro_torch.train import (loss_and_grads, make_eval_step,
                               make_train_step)

ARCHS = ["stablelm-1.6b", "qwen2-72b"]
CPU = torch.device("cpu")


def _cfgs(arch, **overrides):
    j = dataclasses.replace(jcfgs.get_smoke_config(arch), **overrides)
    t = dataclasses.replace(tcfgs.get_smoke_config(arch), **overrides)
    return j, t


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(arch, seed=0, **overrides):
    jcfg, tcfg = _cfgs(arch, dtype="float32", **overrides)
    jp = jinit(jcfg, jax.random.PRNGKey(seed))
    return (jcfg, jp), (tcfg, lm_params_from_numpy(_np_tree(jp), tcfg,
                                                   device="cpu"))


def _batch(vocab, b, s, seed=11, ignore=0):
    """Tokens and next-token labels from numpy; the first ``ignore``
    labels of each row are -1."""
    toks = np.random.default_rng(seed).integers(0, vocab, (b, s + 1))
    labels = toks[:, 1:].copy()
    labels[:, :ignore] = -1
    return toks[:, :-1], labels


def _both(tokens, labels):
    return ({"tokens": jnp.asarray(tokens, jnp.int32),
             "labels": jnp.asarray(labels, jnp.int32)},
            {"tokens": torch.from_numpy(tokens),
             "labels": torch.from_numpy(labels)})


def _close_tree(got, want, rel):
    """Every leaf of ``got`` (port tensors) within rel * max|want| of the
    reference's ``want`` (jax arrays), leaves matched by path."""
    want = dict(leaves(_np_tree(want)))
    got = dict(leaves(got))
    assert got.keys() == want.keys()
    for path, w in want.items():
        w = np.asarray(w, np.float32)
        g = got[path].detach().to(torch.float32).numpy()
        top = float(np.abs(w).max())
        np.testing.assert_allclose(g, w, rtol=0, atol=rel * max(top, 1e-30),
                                   err_msg="/".join(path))


# --- the loss ---------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_chunked_ce_loss_matches_reference(arch):
    jcfg, tcfg = _cfgs(arch, dtype="float32")
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 16, tcfg.d_model)).astype(np.float32)
    head = 0.02 * rng.standard_normal(
        (tcfg.padded_vocab, tcfg.d_model)).astype(np.float32)
    _, labels = _batch(tcfg.vocab_size, 2, 16, ignore=3)

    def jloss(x, head):
        return jlayers.chunked_ce_loss(jcfg, head, x,
                                       jnp.asarray(labels, jnp.int32))

    (jl, jm), (jgx, jgh) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(x),
                                             jnp.asarray(head))
    tx = torch.from_numpy(x).requires_grad_()
    th = torch.from_numpy(head).requires_grad_()
    tl, tm = tlayers.chunked_ce_loss(tcfg, th, tx, torch.from_numpy(labels))
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    assert float(tm["n_tokens"]) == float(jm["n_tokens"]) == 2 * (16 - 3)
    np.testing.assert_allclose(float(tm["ce_sum"].detach()),
                               float(jm["ce_sum"]),
                               rtol=1e-5)
    for g, w in ((tx.grad, jgx), (th.grad, jgh)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-4 * float(np.abs(w).max()))
    # padded vocab columns take no gradient
    assert float(th.grad[tcfg.vocab_size:].abs().max()) == 0.0


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("remat", [True, False])
def test_lm_loss_and_grads_match_reference(arch, remat):
    (jcfg, jp), (tcfg, tp) = _pair(arch)
    jb, tb = _both(*_batch(tcfg.vocab_size, 2, 16, ignore=2))
    jmodel = JLM(jcfg)
    (jl, jm), jg = jax.value_and_grad(
        lambda p: jmodel.loss(p, jb), has_aux=True)(jp)
    tl, tm, tg = loss_and_grads(LM(tcfg), tp, tb, remat=remat)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert set(tm) == {"ce_sum", "n_tokens", "aux_loss"}
    assert float(tm["n_tokens"]) == float(jm["n_tokens"])
    assert float(tm["aux_loss"]) == float(jm["aux_loss"]) == 0.0
    _close_tree(tg, jg, 1e-4)
    # the grads land on the float32 master weights
    assert all(g.dtype == torch.float32 for _, g in leaves(tg))


def test_attention_weights_receive_gradients():
    """Every attention projection of every layer gets a nonzero gradient
    through the flash-attention wrapper (the plain version on the CPU)."""
    cfg = tcfgs.get_smoke_config("stablelm-1.6b")
    params = init_params(cfg, device="cpu")
    live = map_tree(lambda p: p.detach().requires_grad_(), params)
    _, tb = _both(*_batch(cfg.vocab_size, 2, 16))
    loss, _ = LM(cfg).loss(live, tb)
    loss.backward()
    attn = live["stack"]["0_attn"]["attn"]
    for name in ("w_q", "w_k", "w_v", "w_o"):
        g = attn[name].grad
        assert g is not None, name
        for layer in range(cfg.n_layers):
            assert float(g[layer].abs().max()) > 0.0, (name, layer)


def test_eval_step_matches_loss():
    cfg = tcfgs.get_smoke_config("stablelm-1.6b")
    params = init_params(cfg, device="cpu")
    _, tb = _both(*_batch(cfg.vocab_size, 2, 16))
    out = make_eval_step(LM(cfg))(params, tb)
    want, _ = LM(cfg).loss(params, tb, remat=False)
    assert float(out["loss"]) == float(want)
    assert out["loss"].grad_fn is None


# --- optimizer and schedule ---------------------------------------------------


def _grad_trees(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    shapes = {"a": (4, 8), "b": {"c": (5,), "d": (3, 2, 2)}}

    def make(node):
        if isinstance(node, dict):
            return {k: make(v) for k, v in node.items()}
        return (scale * rng.standard_normal(node)).astype(np.float32)

    return make(shapes)


def _jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _ttree(tree):
    return map_tree(torch.from_numpy, tree)


@pytest.mark.parametrize("scale", [0.01, 10.0])   # below and above the clip
def test_global_norm_clip_matches_reference(scale):
    g = _grad_trees(1, scale)
    jg, jn = jclip(_jtree(g), 1.0)
    tg, tn = global_norm_clip(_ttree(g), 1.0)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    _close_tree(tg, jg, 1e-6)


def test_warmup_cosine_matches_reference():
    kw = dict(peak_lr=3e-3, warmup_steps=11, total_steps=100)
    for step in range(0, 130, 3):
        np.testing.assert_allclose(warmup_cosine(step, **kw),
                                   float(jcosine(jnp.int32(step), **kw)),
                                   rtol=1e-6)


@pytest.mark.parametrize("clip_norm", [1.0, 0.0])
def test_adamw_matches_reference_on_identical_gradients(clip_norm):
    lr = lambda s: jcosine(s, peak_lr=1e-2, warmup_steps=2, total_steps=10)
    tlr = lambda s: warmup_cosine(s, peak_lr=1e-2, warmup_steps=2,
                                  total_steps=10)
    jopt = jadamw(lr, clip_norm=clip_norm)
    topt = adamw(tlr, clip_norm=clip_norm)
    params = _grad_trees(2)
    jp, tp = _jtree(params), _ttree(params)
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(4):
        g = _grad_trees(10 + step, scale=0.5)
        ju, js, jm = jopt.update(_jtree(g), js, jp, jnp.int32(step))
        tu, ts, tm = topt.update(_ttree(g), ts, tp, step)
        np.testing.assert_allclose(tm["lr"], float(jm["lr"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        for got, want in ((tu, ju), (ts["m"], js["m"]), (ts["v"], js["v"])):
            _close_tree(got, want, 1e-6)
        jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, ju)
        tp = apply_updates(tp, tu)
        _close_tree(tp, jp, 1e-6)


# --- train step ----------------------------------------------------------------


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_reference(accum):
    (jcfg, jp), (tcfg, tp) = _pair("stablelm-1.6b")
    jb, tb = _both(*_batch(tcfg.vocab_size, 4, 16))
    lr = 1e-3
    jstep = jmake_train_step(JLM(jcfg), jadamw(lr), accum_steps=accum)
    topt = adamw(lr)
    tstep = make_train_step(LM(tcfg), topt, accum_steps=accum)
    _, _, jm = jstep(jp, jadamw(lr).init(jp), jb, jnp.int32(0))
    new, state, tm = tstep(tp, topt.init(tp), tb, 0)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-4)
    assert tm["lr"] == float(jm["lr"])
    # the step is the optimizer applied to the (accumulated) gradients
    if accum == 1:
        _, _, grads = loss_and_grads(LM(tcfg), tp, tb)
    else:
        halves = [{k: v[i * 2:(i + 1) * 2] for k, v in tb.items()}
                  for i in range(2)]
        g0, g1 = (loss_and_grads(LM(tcfg), tp, h)[2] for h in halves)
        grads = map_tree(lambda a, b: (a + b) / 2, g0, g1)
    updates, want_state, _ = topt.update(grads, topt.init(tp), tp, 0)
    want = apply_updates(tp, updates)
    for (_, a), (_, b) in zip(leaves(new), leaves(want)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for (_, a), (_, b) in zip(leaves(state), leaves(want_state)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("arch,accum", [
    ("stablelm-1.6b", 1), ("qwen2-moe-a2.7b", 2), ("recurrentgemma-9b", 1),
    ("deepseek-v3-671b", 1)])
def test_donated_step_is_bit_equal_to_the_pure_step(monkeypatch, arch, accum):
    """``make_train_step(donate=True)`` writes the new parameters and
    AdamW state into the old ones and returns those objects, with the
    pure step's bits over three steps (at the CLI's schedule); with a
    piece of 1000 elements, so that every large leaf is updated piece by
    piece."""
    from repro_torch.optim import base
    monkeypatch.setattr(base, "CHUNK_ELEMENTS", 1000)
    cfg = tcfgs.get_smoke_config(arch)
    model = LM(cfg)
    task = MarkovTask(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4,
                      seed=0)
    opt = adamw(lambda s: warmup_cosine(s, peak_lr=3e-3, warmup_steps=1,
                                        total_steps=3))
    runs = []
    for donate in (False, True):
        params = init_params(cfg, torch.Generator().manual_seed(0), CPU)
        state = opt.init(params)
        step_fn = make_train_step(model, opt, accum_steps=accum,
                                  donate=donate)
        losses = []
        for i in range(3):
            new, new_state, metrics = step_fn(params, state,
                                              task.batch(i, CPU), i)
            assert (new is params and new_state is state) == donate
            params, state = new, new_state
            losses.append(float(metrics["loss"]))
        runs.append((params, state, losses))
    (p0, s0, l0), (p1, s1, l1) = runs
    assert l0 == l1
    assert any(p.numel() > 1000 for _, p in leaves(p0))
    for (path, a), (_, b) in zip(leaves({"p": p0, "s": s0}),
                                 leaves({"p": p1, "s": s1})):
        assert torch.equal(a, b), "/".join(path)


def test_donated_step_needs_a_donated_update():
    from repro_torch.optim import adafactor
    cfg = tcfgs.get_smoke_config("stablelm-1.6b")
    with pytest.raises(ValueError):
        make_train_step(LM(cfg), adafactor(1e-3), donate=True)


def test_accumulated_gradients_match_the_full_batch():
    cfg = dataclasses.replace(tcfgs.get_smoke_config("stablelm-1.6b"),
                              dtype="float32")
    params = init_params(cfg, device="cpu")
    _, tb = _both(*_batch(cfg.vocab_size, 4, 16))
    opt = adamw(1e-3)
    _, _, m1 = make_train_step(LM(cfg), opt, accum_steps=1)(
        params, opt.init(params), tb, 0)
    _, _, m2 = make_train_step(LM(cfg), opt, accum_steps=2)(
        params, opt.init(params), tb, 0)
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m2["grad_norm"]),
                               float(m1["grad_norm"]), rtol=1e-5)
    with pytest.raises(ValueError):
        make_train_step(LM(cfg), opt, accum_steps=3)(
            params, opt.init(params), tb, 0)


# --- data -----------------------------------------------------------------------


def test_markov_table_is_the_reference_table():
    for kw in (dict(vocab_size=500, seq_len=8, global_batch=2, seed=0),
               dict(vocab_size=100, seq_len=32, global_batch=8, seed=2,
                    branching=4)):
        t, j = MarkovTask(**kw), JMarkov(**kw)
        np.testing.assert_array_equal(t._transitions(), j._transitions())
        assert t.entropy_floor_nats == j.entropy_floor_nats


def test_markov_batches_walk_the_table_and_are_step_keyed():
    task = MarkovTask(vocab_size=100, seq_len=32, global_batch=8, seed=2,
                      branching=4)
    nxt = task._transitions()
    b0 = task.batch(0, "cpu")
    assert b0["tokens"].shape == b0["labels"].shape == (8, 32)
    toks = torch.cat([b0["tokens"], b0["labels"][:, -1:]], 1).numpy()
    for t in range(32):
        assert all(toks[r, t + 1] in nxt[toks[r, t]] for r in range(8))
    np.testing.assert_array_equal(b0["labels"][:, :-1], b0["tokens"][:, 1:])
    assert torch.equal(task.batch(0, "cpu")["tokens"], b0["tokens"])
    assert not torch.equal(task.batch(1, "cpu")["tokens"], b0["tokens"])
    s = SyntheticTask(vocab_size=50, seq_len=16, global_batch=3, seed=4)
    a = s.batch(7, "cpu")
    assert a["tokens"].shape == (3, 16) and int(a["tokens"].max()) < 50
    assert torch.equal(s.batch(7, "cpu")["labels"], a["labels"])


def test_training_reduces_loss():
    """``tests/test_system.py::test_training_reduces_loss`` on the port:
    ~60 steps on a small Markov task must visibly reduce CE."""
    cfg = tcfgs.get_smoke_config("stablelm-1.6b")
    model = LM(cfg)
    task = MarkovTask(vocab_size=100, seq_len=32, global_batch=8, seed=2,
                      branching=4)
    opt = adamw(5e-3)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    state = opt.init(params)
    step = make_train_step(model, opt)
    losses = []
    for i in range(60):
        params, state, m = step(params, state, task.batch(i, "cpu"), i)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 1.0, (losses[0], losses[-1])
    assert losses[-1] > task.entropy_floor_nats - 0.2


# --- checkpoints ------------------------------------------------------------------


def _tree(x=1.0):
    return {"a": torch.full((4, 4), x), "b": {"c": torch.arange(5)}}


def test_checkpoint_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(7, _tree(2.5))
    step, restored = mgr.restore_latest(_tree(0.0))
    assert step == 7
    np.testing.assert_allclose(restored["a"], 2.5)
    np.testing.assert_array_equal(restored["b"]["c"], np.arange(5))


def test_checkpoint_corruption_fallback(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _tree(1.0))
    mgr.save(2, _tree(2.0))
    leaf = os.path.join(str(tmp_path), "step_0000000002", "leaf_00000.npy")
    with open(leaf, "r+b") as f:
        f.seek(200)
        f.write(b"\xde\xad\xbe\xef")
    step, restored = mgr.restore_latest(_tree(0.0))
    assert step == 1                             # fell back past corruption
    np.testing.assert_allclose(restored["a"], 1.0)
    with pytest.raises(IOError):
        mgr.restore_latest(_tree(0.0), allow_fallback=False)


def test_checkpoint_gc_keeps_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree(float(s)))
    assert mgr.steps() == [3, 4] and mgr.latest_step() == 4


def test_checkpoint_async_snapshots_before_returning(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = _tree(5.0)
    mgr.save_async(5, tree)
    tree["a"].fill_(-1.0)        # training goes on and changes the tensor
    mgr.wait()
    step, restored = mgr.restore_latest(_tree(0.0))
    assert step == 5 and float(restored["a"][0, 0]) == 5.0


def test_checkpoint_shape_mismatch_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _tree())
    with pytest.raises(ValueError):
        mgr.restore(1, {"a": torch.zeros((2, 2)), "b": {"c": torch.arange(5)}})
    with pytest.raises(ValueError):
        mgr.restore(1, {"a": torch.zeros((4, 4))})      # a leaf short


def _train_state(arch="stablelm-1.6b"):
    """The reference's (params, AdamW state) after one step, and the same
    state carried over to the port."""
    jcfg, tcfg = _cfgs(arch)
    jp = jinit(jcfg, jax.random.PRNGKey(4))
    opt = jadamw(1e-3)
    jb, _ = _both(*_batch(tcfg.vocab_size, 2, 16))
    jp, js, _ = jmake_train_step(JLM(jcfg), opt)(jp, opt.init(jp), jb,
                                                 jnp.int32(0))
    tstate = (lm_params_from_numpy(_np_tree(jp), tcfg, device="cpu"),
              adamw_state_from_numpy(_np_tree(js), tcfg, device="cpu"))
    return (jp, js), tstate


def test_port_restores_a_reference_checkpoint(tmp_path):
    jstate, tstate = _train_state()
    JManager(str(tmp_path)).save(3, jstate)
    like = map_tree(torch.zeros_like, tstate[0]), {
        k: map_tree(torch.zeros_like, v) for k, v in tstate[1].items()}
    step, restored = CheckpointManager(str(tmp_path)).restore_latest(like)
    assert step == 3
    for (pa, a), (pb, b) in zip(leaves({"p": restored[0], "o": restored[1]}),
                                leaves({"p": tstate[0], "o": tstate[1]})):
        assert pa == pb and torch.equal(a, b), pa


def test_reference_restores_a_port_checkpoint(tmp_path):
    jstate, tstate = _train_state()
    CheckpointManager(str(tmp_path)).save(2, tstate)
    step, restored = JManager(str(tmp_path)).restore_latest(jstate)
    assert step == 2
    for a, b in zip(jax.tree_util.tree_leaves(restored),
                    jax.tree_util.tree_leaves(jstate)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_adamw_state_from_numpy_checks_the_template():
    _, tcfg = _cfgs("stablelm-1.6b")
    jstate, tstate = _train_state()
    m = _np_tree(jstate[1]["m"])
    with pytest.raises(ValueError, match="expected keys"):
        adamw_state_from_numpy({"m": m}, tcfg, device="cpu")
    m["embed"] = m["embed"][:, :3]
    with pytest.raises(ValueError, match="embed"):
        adamw_state_from_numpy({"m": m, "v": m}, tcfg, device="cpu")
    assert all(t.dtype == torch.float32 for _, t in leaves(tstate[1]))


# --- fault tolerance ---------------------------------------------------------------


def test_fault_recovery_bit_exact(tmp_path):
    """``tests/test_system.py::test_fault_recovery_bit_exact`` on the port:
    a crash mid-run + restore-from-checkpoint reproduces the exact final
    state of an uninterrupted run."""
    cfg = tcfgs.get_smoke_config("stablelm-1.6b")
    model = LM(cfg)
    task = MarkovTask(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4,
                      seed=5)
    opt = adamw(1e-3)
    step_fn = make_train_step(model, opt)

    def one(state, step):
        p, s = state
        p, s, _ = step_fn(p, s, task.batch(step, "cpu"), step)
        return (p, s)

    def fresh_state():
        p = init_params(cfg, torch.Generator().manual_seed(1), "cpu")
        return (p, opt.init(p))

    mgr_a = CheckpointManager(str(tmp_path / "a"), keep=5)
    state_a, rep_a = FaultTolerantRunner(one, mgr_a, checkpoint_every=4).run(
        fresh_state(), 0, 12)
    assert rep_a.failures_recovered == 0 and rep_a.checkpoints_written == 3

    mgr_b = CheckpointManager(str(tmp_path / "b"), keep=5)
    crashed = {"done": False}

    def fault(step):
        if step == 9 and not crashed["done"]:
            crashed["done"] = True
            raise RuntimeError("injected preemption")

    state_b, rep_b = FaultTolerantRunner(one, mgr_b, checkpoint_every=4).run(
        fresh_state(), 0, 12, fault_hook=fault)
    assert rep_b.failures_recovered == 1 and rep_b.final_step == 12
    for (pa, a), (pb, b) in zip(leaves(state_a[0]), leaves(state_b[0])):
        assert pa == pb and torch.equal(a, b), pa


def test_straggler_detection(tmp_path):
    """A persistently slow step is detected and triggers recovery."""
    import time
    mgr = CheckpointManager(str(tmp_path), keep=1)
    calls = {"n": 0}

    def slow_after_6(state, step):
        calls["n"] += 1
        time.sleep(0.12 if step >= 6 and calls["n"] < 40 else 0.002)
        return state

    runner = FaultTolerantRunner(slow_after_6, mgr, checkpoint_every=100,
                                 straggler_factor=3.0, straggler_patience=3,
                                 max_restarts=50)
    _, report = runner.run({"x": 0}, 0, 12)
    assert report.stragglers_detected >= 3
    assert report.failures_recovered >= 1


# --- the CLI ----------------------------------------------------------------------------


def test_train_cli_runs_on_cpu(capsys):
    _, losses = ttrain.main(["--device", "cpu", "--steps", "3", "--batch",
                             "2", "--seq", "16"])
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert "first loss" in capsys.readouterr().out


def test_train_loop_resumes_from_its_checkpoint(tmp_path, capsys):
    kw = dict(steps=20, batch=2, seq=16, ckpt_dir=str(tmp_path),
              device="cpu")
    crashed = {"done": False}

    def fault(step):
        if step == 13 and not crashed["done"]:
            crashed["done"] = True
            raise RuntimeError("injected preemption")

    state_a, _, _ = ttrain.train_loop("stablelm-1.6b", fault_hook=fault, **kw)
    out = capsys.readouterr().out
    assert "1 recoveries" in out and "2 checkpoints" in out
    assert CheckpointManager(str(tmp_path)).latest_step() == 20
    # a second run finds step 20 and has nothing left to do
    state_b, _, _ = ttrain.train_loop("stablelm-1.6b", **kw)
    assert "resumed from step 20" in capsys.readouterr().out
    for (_, a), (_, b) in zip(leaves(state_a[0]), leaves(state_b[0])):
        assert torch.equal(a, b)


def test_train_loop_donates_its_step(monkeypatch):
    """The train loop's step is donated (AdamW has an ``update_``): every
    step writes into the parameter storage of the first, and the losses
    equal the pure step's bit for bit."""
    real = ttrain.make_train_step
    runs = []

    def recording(model, opt, *, force_pure=False, **kw):
        if force_pure:
            kw["donate"] = False
        step_fn = real(model, opt, **kw)
        seen = {"donate": kw.get("donate", False), "storage": []}
        runs.append(seen)

        def step(params, state, batch, i):
            new, new_state, metrics = step_fn(params, state, batch, i)
            seen["storage"].append([p.data_ptr() for _, p in leaves(new)])
            return new, new_state, metrics
        return step

    kw = dict(steps=4, batch=2, seq=16, log_every=1, device="cpu")
    monkeypatch.setattr(ttrain, "make_train_step", recording)
    _, donated, _ = ttrain.train_loop("stablelm-1.6b", **kw)
    monkeypatch.setattr(ttrain, "make_train_step",
                        lambda *a, **k: recording(*a, force_pure=True, **k))
    _, pure, _ = ttrain.train_loop("stablelm-1.6b", **kw)
    (d_run, p_run) = runs
    assert d_run["donate"] and not p_run["donate"]
    assert len(d_run["storage"]) == 4
    assert all(s == d_run["storage"][0] for s in d_run["storage"])
    assert len(donated) == 4 and donated == pure


def test_train_cli_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        ttrain.main(["--steps", "1"])
