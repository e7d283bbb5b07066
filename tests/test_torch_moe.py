"""The port's MoE layer and MLA on the CPU, against the reference.

``models/moe.py`` (router, shared experts, sort-based per-row dispatch
with capacity drops, the combine) and MLA in ``models/attention.py``
(``mla_full`` through the flash-attention kernel's wrapper, whose V is
narrower than q and k; the absorbed ``mla_decode``), and the two configs
that use them, qwen2-moe-a2.7b and deepseek-v3-671b: configs, parameter
counts, ``LM`` prefill, decode, loss and gradients, and the serving
engine.  The reference's ``init_params`` tree is carried over with
``convert.lm_params_from_numpy`` and both packages get the same inputs,
drawn with numpy from a seed.  Tolerances, and why:

* float32 (``dtype="float32"``): the packages sum the same products in
  other orders (XLA's and torch's CPU matmuls), so one MoE layer is held
  to rtol 1e-5 / atol 1e-6, logits through the whole model to rtol 1e-4
  / atol 1e-5, the loss to rtol 1e-5 and each gradient leaf to 1e-4 *
  max|g| of ``jax.grad``'s, as ``test_torch_train.py`` holds the dense
  models; routing indices are equal;
* bfloat16 (the configs' default): each package rounds its activations
  to bf16 at its own places, so logits are held to the reference's own
  decode-equivalence bound, rtol/atol 5e-2 (``tests/test_models.py``);
* greedy tokens and parameter counts: exactly equal (the engines in
  float32, as ``test_torch_models.py`` explains);
* the layer's gathers against ``torch.gather`` in the port alone:
  forward and backward bit-equal (the fixed-order backward adds a
  token's slots in the order the CPU's ``scatter_add_`` adds them).
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
from repro.models import attention as jattn
from repro.models import init_params as jinit
from repro.models import moe as jmoe
from repro.models import param_counts as jcounts
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JEngine
from repro_torch import configs as tcfgs
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import (LM, compute_params, init_params,
                                param_counts)
from repro_torch.models import attention as tattn
from repro_torch.models import moe as tmoe
from repro_torch.models.params import leaves
from repro_torch.serving import Request, ServingEngine
from repro_torch.train import loss_and_grads

ARCHS = ["qwen2-moe-a2.7b", "deepseek-v3-671b"]
F32 = dict(rtol=1e-4, atol=1e-5)
LAYER_F32 = dict(rtol=1e-5, atol=1e-6)
BF16 = dict(rtol=5e-2, atol=5e-2)


def _cfgs(arch, **overrides):
    j = dataclasses.replace(jcfgs.get_smoke_config(arch), **overrides)
    t = dataclasses.replace(tcfgs.get_smoke_config(arch), **overrides)
    return j, t


def _with_cf(cfg, cf):
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cf))


def _pair(arch, seed=0, cf=None, **overrides):
    """(reference cfg, params) and (port cfg, params) holding the same
    weights (``cf``: the experts' capacity factor)."""
    jcfg, tcfg = _cfgs(arch, **overrides)
    if cf is not None:
        jcfg, tcfg = _with_cf(jcfg, cf), _with_cf(tcfg, cf)
    jp = jinit(jcfg, jax.random.PRNGKey(seed))
    tp = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                              device="cpu")
    return (jcfg, jp), (tcfg, tp)


def _np(x):
    return np.asarray(x, np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def _tokens(vocab, shape, seed=7):
    return np.random.default_rng(seed).integers(0, vocab, shape)


def _moe_layer(arch, cf=None):
    """(reference cfg, port cfg, the reference's and the port's MoE params
    of the first stacked block, float32)."""
    (jcfg, jp), (tcfg, tp) = _pair(arch, cf=cf, dtype="float32")
    jb = jax.tree_util.tree_map(lambda a: a[0], jp["stack"]["0_attn"]["mlp"])
    tb = {k: v[0] for k, v in tp["stack"]["0_attn"]["mlp"].items()}
    return jcfg, tcfg, jb, tb


# --- configs, params ---------------------------------------------------------------


def test_configs_match_reference_field_for_field():
    for arch in ARCHS:
        assert arch in tcfgs.ARCHS
        for get in ("get_config", "get_smoke_config"):
            j = getattr(jcfgs, get)(arch)
            t = getattr(tcfgs, get)(arch)
            assert dataclasses.asdict(j) == dataclasses.asdict(t), arch
            assert dataclasses.asdict(j.layer_plan()) == \
                dataclasses.asdict(t.layer_plan())
            assert j.mla is None or t.mla.qk_head_dim == j.mla.qk_head_dim
            assert j.mla is None or t.mla.cache_dim == j.mla.cache_dim
    m = tcfgs.get_config("deepseek-v3-671b").moe
    assert (m.capacity_factor, m.aux_loss_coef) == (1.25, 1e-3)


@pytest.mark.parametrize("arch,total,active", [
    ("qwen2-moe-a2.7b", 14_322_550_784, 2_695_940_096),
    ("deepseek-v3-671b", 671_052_094_464, 37_577_972_736)])
def test_param_counts_equal_reference(arch, total, active):
    """Totals and active counts equal the reference's, full and smoke."""
    assert param_counts(tcfgs.get_config(arch)) == (total, active) == \
        jcounts(jcfgs.get_config(arch))
    assert param_counts(tcfgs.get_smoke_config(arch)) == \
        jcounts(jcfgs.get_smoke_config(arch))


def test_param_counts_match_published():
    """The published sizes within the reference's 5 %
    (``tests/test_models.py::test_param_counts_match_published``)."""
    for arch, want in (("deepseek-v3-671b", 671e9),
                       ("qwen2-moe-a2.7b", 14.3e9)):
        total, _ = param_counts(tcfgs.get_config(arch))
        assert abs(total - want) / want < 0.05, (arch, total, want)


def test_moe_active_params():
    """The twin of ``tests/test_models.py::test_moe_active_params``."""
    _, active = param_counts(tcfgs.get_config("deepseek-v3-671b"))
    assert 35e9 < active < 40e9              # paper: 37B activated
    _, active = param_counts(tcfgs.get_config("qwen2-moe-a2.7b"))
    assert 2.0e9 < active < 3.5e9            # model card: 2.7B activated


@pytest.mark.parametrize("arch", ARCHS)
def test_params_convert_through_the_templates(arch):
    """``lm_params_from_numpy`` takes the reference's tree, the new leaves
    included (router, experts, shared experts, MLA), with the shapes and
    dtypes of the port's own ``init_params``; ``compute_params`` casts the
    new matmul weights and leaves MLA's norm scales in float32."""
    (_, jp), (tcfg, tp) = _pair(arch)
    mine = init_params(tcfg, device="cpu")
    got = {p: (tuple(t.shape), t.dtype) for p, t in leaves(tp)}
    assert got == {p: (tuple(t.shape), t.dtype) for p, t in leaves(mine)}
    for path, a in leaves(jax.tree_util.tree_map(np.asarray, jp)):
        np.testing.assert_array_equal(
            dict(leaves(tp))[path].numpy(), a, err_msg="/".join(path))
    names = {p[-1] for p in got}
    assert {"router", "we_in", "we_gate", "we_out", "ws_in", "ws_gate",
            "ws_out"} <= names
    bf = compute_params(dataclasses.replace(tcfg, dtype="bfloat16"), tp)
    for path, t in leaves(bf):
        want = torch.float32 if path[-1] in (
            "q_norm", "kv_norm", "ln1", "ln2", "final_norm") \
            else torch.bfloat16
        assert t.dtype == want, path
    if arch == "deepseek-v3-671b":
        assert {"w_dq", "q_norm", "w_uq", "w_dkv", "kv_norm", "w_uk",
                "w_uv"} <= names
        # the dense prefix layer has the dense MLP, the stack the experts
        assert "w_in" in tp["prefix"]["0_attn"]["mlp"]
        assert "router" in tp["stack"]["0_attn"]["mlp"]
        full = tcfgs.get_config(arch)
        assert full.d_ff == 18432 and full.dense_prefix == 3


# --- the MoE layer -------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("cf", [None, 0.5])
def test_moe_apply_matches_reference(arch, cf):
    """One MoE layer at the smoke config (and at capacity factor 0.5,
    where slots drop): the same routes, probabilities, aux loss and
    output as the reference's, in float32."""
    jcfg, tcfg, jb, tb = _moe_layer(arch, cf)
    x = np.random.default_rng(1).standard_normal(
        (2, 16, tcfg.d_model)).astype(np.float32)
    jtop, jidx, jaux = jmoe._router(jcfg, jb, jnp.asarray(x))
    ttop, tidx, taux = tmoe._router(tcfg, tb, _t(x))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(ttop.numpy(), _np(jtop), **LAYER_F32)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    jout, jaux2 = jmoe.moe_apply(jcfg, jb, jnp.asarray(x))
    tout, taux2 = tmoe.moe_apply(tcfg, tb, _t(x))
    np.testing.assert_allclose(tout.numpy(), _np(jout), **LAYER_F32)
    assert float(taux2) == float(taux)
    if cf == 0.5:
        # some slot dropped: its token's output lacks that expert's term
        cap = tmoe.capacity(tcfg, 16)
        counts = np.stack([np.bincount(r, minlength=tcfg.moe.n_routed)
                           for r in tidx.reshape(2, -1).numpy()])
        assert (counts > cap).any()


def test_capacity_is_the_reference_arithmetic():
    """C = ceil(S k cf / E) in quarters of cf, at least 1: 86 for
    qwen2-moe and 40 for deepseek at 1023 tokens, 1 for a decode step."""
    q = tcfgs.get_config("qwen2-moe-a2.7b")
    d = tcfgs.get_config("deepseek-v3-671b")
    assert tmoe.capacity(q, 1023) == 86 and tmoe.capacity(d, 1023) == 40
    assert tmoe.capacity(q, 1) == 1 and tmoe.capacity(d, 1) == 1
    for cf in (0.5, 1.0, 1.25, 3.3, 16.0):
        for s in (1, 7, 16, 1023):
            cfg = _with_cf(d, cf)
            m = cfg.moe
            want = max(-(-s * m.top_k * int(4 * cf) // (4 * m.n_routed)), 1)
            assert tmoe.capacity(cfg, s) == want


@pytest.mark.parametrize("arch", ARCHS)
def test_top_k_ties_take_the_lower_expert_first(arch):
    """Exactly tied router scores (integer activations and router columns
    repeated, so every sum is exact) route to the lower expert first, as
    ``jax.lax.top_k`` does; and the whole layer agrees with the
    reference on them."""
    jcfg, tcfg, jb, tb = _moe_layer(arch)
    e, d = tcfg.moe.n_routed, tcfg.d_model
    rng = np.random.default_rng(2)
    cols = rng.integers(-2, 3, (d, 3)).astype(np.float32)
    router = cols[:, rng.integers(0, 3, e)] * 2.0 ** -6   # 3 distinct columns
    x = rng.integers(-2, 3, (2, 16, d)).astype(np.float32)
    jb = dict(jb, router=jnp.asarray(router))
    tb = dict(tb, router=_t(router))
    jtop, jidx, _ = jmoe._router(jcfg, jb, jnp.asarray(x))
    ttop, tidx, _ = tmoe._router(tcfg, tb, _t(x))
    logits = x @ router
    # every token has a tie within its top k, and the lower index wins it
    ties = 0
    for row_l, row_i in zip(logits.reshape(-1, e),
                            tidx.reshape(-1, tcfg.moe.top_k).numpy()):
        picked = row_l[row_i]
        ties += int(np.any(picked[:-1] == picked[1:]))
        for a, b in zip(row_i[:-1], row_i[1:]):
            assert row_l[a] > row_l[b] or (row_l[a] == row_l[b] and a < b)
    assert ties > 0
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(ttop.numpy(), _np(jtop), **LAYER_F32)
    jout, _ = jmoe.moe_apply(jcfg, jb, jnp.asarray(x))
    tout, _ = tmoe.moe_apply(tcfg, tb, _t(x))
    np.testing.assert_allclose(tout.numpy(), _np(jout), **LAYER_F32)


def test_combine_adds_in_expert_order():
    """The combine adds a token's k outputs one by one in ascending expert
    order, whatever order top-k gave them, and a dropped slot adds 0:
    bf16 terms 1, 2^-8 and 2^-8 sum to 1 in that order (each half-ulp
    add rounds to even) and to 1 + 2^-7 the other way round."""
    one, tiny = 1.0, 2.0 ** -8
    # 3 experts x 1 slot; token 0 holds its experts in the order (2, 0, 1),
    # token 1 in (1, 2, 0) with expert 0's slot dropped
    eo = torch.tensor([[[one], [tiny], [tiny]]], dtype=torch.bfloat16)
    idx = torch.tensor([[[2, 0, 1], [1, 2, 0]]])
    slot_of = torch.tensor([[[2, 0, 1], [1, 2, 3]]])
    out = tmoe._combine(eo, slot_of, idx)
    assert torch.equal(out, torch.tensor([[[1.0], [2.0 ** -7]]],
                                         dtype=torch.bfloat16))
    # the order matters: the other way round, token 0 would be 1 + 2^-7
    bf = torch.tensor([tiny, tiny, one], dtype=torch.bfloat16)
    assert float((bf[0] + bf[1]) + bf[2]) == 1.0078125


def _routed(arch, cf, seed=1):
    """(port cfg, the first stacked block's MoE params, x (2, 16, D) a
    float32 leaf, top, idx and the dispatch (slot_tok, slot_w, slot_of) of
    x through the router, the capacity)."""
    _, tcfg, _, tb = _moe_layer(arch, cf)
    x = _t(np.random.default_rng(seed).standard_normal(
        (2, 16, tcfg.d_model))).requires_grad_()
    top, idx, _ = tmoe._router(tcfg, tb, x)
    cap = tmoe.capacity(tcfg, 16)
    disp = tmoe._dispatch(idx, top, s=16, e=tcfg.moe.n_routed, cap=cap)
    return tcfg, tb, x, top, idx, disp, cap


def _gathered(src, index):
    """``tmoe._route`` through ``torch.gather``, whose autograd is a
    ``scatter_add_``: the rows of src (B, N, D) padded with a zero row at
    index[b, i, j] (B, M, k), summed over j in that order."""
    b, m, k = index.shape
    d = src.shape[-1]
    src = torch.cat([src, src.new_zeros((b, 1, d))], dim=1)
    rows = torch.gather(src, 1, index.reshape(b, m * k, 1).expand(
        b, m * k, d)).reshape(b, m, k, d)
    out = rows[:, :, 0]
    for j in range(1, k):
        out = out + rows[:, :, j]
    return out


def _grad(out, leaf, seed):
    g = _t(np.random.default_rng(seed).standard_normal(tuple(out.shape)))
    return torch.autograd.grad(out, leaf, g, retain_graph=True)[0]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("cf", [None, 0.5, 0.25])
def test_slot_gathers_backward_is_bit_equal_to_gathers_autograd(arch, cf):
    """The MoE layer's three gathers with a gradient, the slots' tokens
    (``_gather_slots``), their router weights (``_dispatch``) and the
    combine, against ``torch.gather`` on the same indices in float32 on
    the CPU: forward and backward bit-equal.  ``torch.gather``'s backward
    is a ``scatter_add_``, which on the CPU adds a token's slots in slot
    order, i.e. by ascending expert, the order the fixed-order backward
    adds them in.  At capacity factor 1.25 (the configs') the rows have
    empty slots; at 0.5 and 0.25 slots drop."""
    tcfg, _, x, top, idx, (slot_tok, slot_w, slot_of), cap = _routed(arch, cf)
    b, s, k = idx.shape
    e = tcfg.moe.n_routed
    dropped = int((slot_of == e * cap).sum())
    empty = int((slot_tok == s).sum())
    assert (dropped > 0) if cf is not None else (empty > 0 and dropped < 8)
    by_expert = tmoe._by_expert(slot_of, idx)
    # the slots' tokens
    gx = tmoe._gather_slots(x, slot_tok, slot_of, idx, e=e, cap=cap)
    want = _gathered(x, slot_tok[..., None]).reshape(gx.shape)
    assert torch.equal(gx, want)
    assert torch.equal(_grad(gx, x, 3), _grad(want, x, 3))
    # the slots' weights: the (token, j) each slot holds, S*k when empty
    src = torch.full((b, e * cap + 1), s * k)
    src.scatter_(1, slot_of.reshape(b, s * k),
                 torch.arange(s * k).expand(b, -1))
    want_w = _gathered(top.reshape(b, s * k, 1), src[:, :-1, None])[..., 0]
    assert torch.equal(slot_w, want_w)
    assert torch.equal(_grad(slot_w, top, 4), _grad(want_w, top, 4))
    # the combine, on outputs that depend on x
    eo = (gx.reshape(b, e * cap, -1) * 1.5).detach().requires_grad_()
    out = tmoe._combine(eo, slot_of, idx)
    want_o = _gathered(eo, by_expert)
    assert torch.equal(out, want_o)
    assert torch.equal(_grad(out, eo, 5), _grad(want_o, eo, 5))


class _AtenLog(TorchDispatchMode):
    """Records every aten op with its arguments."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.ops.append((func, args, kwargs))
        return func(*args, **kwargs)


def _accumulating(ops) -> list[str]:
    """The ops that add colliding writes: scatter_add, index_add,
    scatter_reduce, scatter with a reduce, index_put with accumulate."""
    hits = []
    for func, args, kwargs in ops:
        name = func._schema.name.split("::")[-1].rstrip("_")
        if name in ("scatter_add", "index_add", "scatter_reduce"):
            hits.append(str(func))
        elif name == "scatter" and ("reduce" in kwargs
                                    or "reduce" in func._overloadname):
            hits.append(str(func))
        elif name in ("index_put", "_index_put_impl") and kwargs.get(
                "accumulate", len(args) > 3 and bool(args[3])):
            hits.append(str(func))
    return hits


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("cf", [None, 0.25])
def test_moe_backward_calls_no_accumulating_scatter(arch, cf):
    """``moe_apply``'s backward (to x and every parameter, the router's
    included) runs no ``scatter_add``, ``index_add``, ``scatter_reduce``
    or ``index_put_(accumulate=True)``: the ops whose CUDA kernels add
    colliding rows with atomics.  The recorder sees ``torch.gather``'s own
    backward as a ``scatter_add``."""
    tcfg, tb, x, *_ = _routed(arch, cf)
    params = {k: v.detach().requires_grad_() for k, v in tb.items()}
    out, aux = tmoe.moe_apply(tcfg, params, x)
    loss = (out * _t(np.random.default_rng(6).standard_normal(
        tuple(out.shape)))).sum() + aux
    log = _AtenLog()
    with log:
        grads = torch.autograd.grad(loss, [x, *params.values()])
    assert all(g is not None and bool(torch.isfinite(g).all())
               for g in grads)
    assert float(grads[0].abs().max()) > 0
    assert float(grads[1 + list(params).index("router")].abs().max()) > 0
    names = {str(f) for f, _, _ in log.ops}
    assert any("gather" in n for n in names), names
    assert _accumulating(log.ops) == []
    # the recorder sees an accumulating scatter where one runs
    probe = torch.zeros(3, 2, requires_grad=True)
    picked = torch.gather(probe, 0, torch.tensor([[0, 1], [0, 0]]))
    control = _AtenLog()
    with control:
        torch.autograd.grad(picked.sum(), probe)
    assert _accumulating(control.ops)


@pytest.mark.parametrize("arch", ARCHS)
def test_aux_loss_matches_reference(arch):
    """The load-balance loss of the whole model (``metrics["aux_loss"]``,
    the MoE layers' sum) equals the reference's in float32; DeepSeek's
    sigmoid router and qwen2-moe's softmax one both use a softmax for
    it."""
    (jcfg, jp), (tcfg, tp) = _pair(arch, dtype="float32")
    toks = _tokens(tcfg.vocab_size, (2, 16))
    _, jm = JLM(jcfg).loss(jp, {"tokens": jnp.asarray(toks),
                                "labels": jnp.asarray(toks)})
    _, tm = LM(tcfg).loss(tp, {"tokens": torch.from_numpy(toks),
                               "labels": torch.from_numpy(toks)})
    assert float(tm["aux_loss"]) > 0
    np.testing.assert_allclose(float(tm["aux_loss"]),
                               float(jm["aux_loss"]), rtol=1e-5)


def test_moe_capacity_drops_are_bounded():
    """The twin of ``tests/test_models.py::
    test_moe_capacity_drops_are_bounded``: dropped tokens fall through the
    residual, so the loss at capacity factor 0.5 stays finite and close
    to the no-drop loss; both are the reference's (bf16 bound)."""
    (jcfg, jp), (tcfg, tp) = _pair("qwen2-moe-a2.7b", cf=16.0)
    toks = _tokens(tcfg.vocab_size, (2, 16), seed=4)
    tb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(toks)}
    jbt = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}
    losses = {}
    for cf in (0.5, 16.0):
        tl, _ = LM(_with_cf(tcfg, cf)).loss(tp, tb)
        jl, _ = jax.jit(JLM(_with_cf(jcfg, cf)).loss)(jp, jbt)
        np.testing.assert_allclose(float(tl), float(jl), **BF16)
        losses[cf] = float(tl)
    assert all(np.isfinite(v) for v in losses.values())
    assert abs(losses[0.5] - losses[16.0]) < 1.0
    assert losses[0.5] != losses[16.0]


# --- MLA --------------------------------------------------------------------------------


def test_mla_full_and_decode_match_reference():
    """``mla_full`` (through the kernel's wrapper, V narrower than q and
    k) with its latent cache, then three absorbed ``mla_decode`` steps at
    per-lane positions, against the reference in float32."""
    (jcfg, jp), (tcfg, tp) = _pair("deepseek-v3-671b", dtype="float32")
    jb, tb = jp["prefix"]["0_attn"]["attn"], tp["prefix"]["0_attn"]["attn"]
    rng = np.random.default_rng(5)
    b, s, max_len = 2, 9, 16
    x = rng.standard_normal((b, s + 3, tcfg.d_model)).astype(np.float32)
    jy, jlat = jattn.mla_full(jcfg, jb, jnp.asarray(x[:, :s]),
                              return_cache=True)
    ty, tlat = tattn.mla_full(tcfg, tb, _t(x[:, :s]), return_cache=True)
    np.testing.assert_allclose(ty.numpy(), _np(jy), **F32)
    np.testing.assert_allclose(tlat.numpy(), _np(jlat), **F32)
    jcache = jattn.init_mla_cache(jcfg, b, max_len)
    jcache = {"latent": jcache["latent"].at[:, :s].set(jlat)}
    tcache = tattn.init_mla_cache(tcfg, b, max_len, device="cpu")
    tcache["latent"][:, :s] = tlat
    pos = np.array([s, s - 2])            # lanes at their own depths
    for i in range(3):
        xi = x[:, s + i:s + i + 1]
        jy, jcache = jattn.mla_decode(jcfg, jb, jnp.asarray(xi), jcache,
                                      jnp.asarray(pos + i, jnp.int32))
        ty, same = tattn.mla_decode(tcfg, tb, _t(xi), tcache,
                                    torch.from_numpy(pos + i))
        assert same is tcache              # written in place
        np.testing.assert_allclose(ty.numpy(), _np(jy), **F32)
        np.testing.assert_allclose(tcache["latent"].numpy(),
                                   _np(jcache["latent"]), **F32)


def test_mla_decode_past_the_cache_writes_nothing():
    """A lane at ``pos`` >= max_len leaves its cache as it was, as the
    reference's out-of-bounds scatter drops the update, and still
    attends to every cached position."""
    (jcfg, jp), (tcfg, tp) = _pair("deepseek-v3-671b", dtype="float32")
    jb, tb = jp["prefix"]["0_attn"]["attn"], tp["prefix"]["0_attn"]["attn"]
    rng = np.random.default_rng(6)
    lat = rng.standard_normal((2, 6, tcfg.mla.cache_dim)).astype(np.float32)
    x = rng.standard_normal((2, 1, tcfg.d_model)).astype(np.float32)
    pos = np.array([6, 3])
    tcache = {"latent": _t(lat).clone()}
    ty, _ = tattn.mla_decode(tcfg, tb, _t(x), tcache, torch.from_numpy(pos))
    jy, jc = jattn.mla_decode(jcfg, jb, jnp.asarray(x),
                              {"latent": jnp.asarray(lat)},
                              jnp.asarray(pos, jnp.int32))
    np.testing.assert_array_equal(tcache["latent"][0].numpy(), lat[0])
    np.testing.assert_allclose(tcache["latent"].numpy(), _np(jc["latent"]),
                               **F32)
    np.testing.assert_allclose(ty.numpy(), _np(jy), **F32)


# --- the whole model ----------------------------------------------------------------------


def _prefill_and_decode(arch, dtype, steps=3):
    (jcfg, jp), (tcfg, tp) = _pair(arch, dtype=dtype)
    b, s = 2, 12
    toks = _tokens(100, (b, s + steps))
    jm, tm = JLM(jcfg), LM(tcfg)
    jcache, jlg = jax.jit(lambda p, bt: jm.prefill(p, bt, max_len=s + 8))(
        jp, {"tokens": jnp.asarray(toks[:, :s], jnp.int32)})
    tparams = compute_params(tcfg, tp)
    tcache, tlg = tm.prefill(tparams, {"tokens": torch.from_numpy(
        toks[:, :s])}, max_len=s + 8)
    pairs = [(_np(jlg), tlg.numpy())]
    jstep = jax.jit(jm.decode_step)
    for i in range(steps):
        jlg, jcache = jstep(jp, jcache,
                            jnp.asarray(toks[:, s + i][:, None], jnp.int32))
        tlg, tcache = tm.decode_step(
            tparams, tcache, torch.from_numpy(toks[:, s + i][:, None]))
        pairs.append((_np(jlg), tlg.numpy()))
    return pairs


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_reference(arch, dtype):
    tol = F32 if dtype == "float32" else BF16
    for want, got in _prefill_and_decode(arch, dtype):
        np.testing.assert_allclose(got, want, **tol)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_matches_full_forward(arch, dtype):
    """Teacher-forced decode == one-shot prefill at the same length, in
    the port alone, at capacity factor 16 (no drops), as the reference's
    test_decode_matches_full_forward runs it."""
    tcfg = _with_cf(dataclasses.replace(tcfgs.get_smoke_config(arch),
                                        dtype=dtype), 16.0)
    model = LM(tcfg)
    params = compute_params(tcfg, init_params(tcfg, device="cpu"))
    b, s = 2, 12
    toks = torch.from_numpy(_tokens(100, (b, s + 3)))
    cache, _ = model.prefill(params, {"tokens": toks[:, :s]}, max_len=s + 8)
    for i in range(3):
        lg, cache = model.decode_step(params, cache, toks[:, s + i][:, None])
    _, lg_full = model.prefill(params, {"tokens": toks[:, :s + 3]},
                               max_len=s + 8)
    tol = F32 if dtype == "float32" else BF16
    np.testing.assert_allclose(lg.numpy(), lg_full.numpy(), **tol)
    assert int(cache["pos"][0]) == s + 3


def test_batch_order_invariance():
    """The twin of ``tests/test_invariants.py::test_batch_order_invariance``
    (qwen2-moe, bf16): per-row dispatch leaks nothing across rows."""
    cfg = tcfgs.get_smoke_config("qwen2-moe-a2.7b")
    params = compute_params(cfg, init_params(cfg, device="cpu"))
    model = LM(cfg)
    toks = torch.from_numpy(_tokens(100, (2, 10), seed=3))
    _, lg = model.prefill(params, {"tokens": toks}, max_len=16)
    _, lg_swapped = model.prefill(params, {"tokens": toks.flip(0)},
                                  max_len=16)
    np.testing.assert_allclose(lg.numpy(), lg_swapped.flip(0).numpy(),
                               atol=1e-4)


def test_causality():
    """The twin of ``tests/test_invariants.py::test_causality`` for
    deepseek (MLA and MoE, bf16): a change to future tokens changes no
    earlier logits and no earlier latent cache entry."""
    cfg = tcfgs.get_smoke_config("deepseek-v3-671b")
    params = compute_params(cfg, init_params(cfg, device="cpu"))
    model = LM(cfg)
    b, s, cut = 2, 12, 6
    toks = torch.from_numpy(_tokens(100, (b, s), seed=1))
    toks2 = toks.clone()
    toks2[:, cut:] = (toks[:, cut:] + 17) % 100
    _, lg_a = model.prefill(params, {"tokens": toks[:, :cut]}, max_len=s + 4)
    _, lg_b = model.prefill(params, {"tokens": toks2[:, :cut]},
                            max_len=s + 4)
    assert torch.equal(lg_a, lg_b)
    full_a, _ = model.prefill(params, {"tokens": toks}, max_len=s + 4)
    full_b, _ = model.prefill(params, {"tokens": toks2}, max_len=s + 4)
    lat = [(pa, a) for pa, a in leaves(full_a) if pa[-1] == "latent"]
    assert len(lat) == 2                   # the prefix layer and the stack
    for (path, a), (_, bb) in zip(lat, [(p, t) for p, t in leaves(full_b)
                                        if p[-1] == "latent"]):
        np.testing.assert_allclose(a[..., :cut, :].float().numpy(),
                                   bb[..., :cut, :].float().numpy(),
                                   atol=1e-5, err_msg="/".join(path))


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_grads_match_reference(arch):
    """``LM.loss`` (ce + the aux loss) and its gradients against
    ``jax.value_and_grad`` of the reference's, in float32, at PR 14's
    bounds: the loss to rtol 1e-5, each leaf to 1e-4 * max|g|."""
    (jcfg, jp), (tcfg, tp) = _pair(arch, dtype="float32")
    toks = np.random.default_rng(11).integers(0, tcfg.vocab_size, (2, 17))
    labels = toks[:, 1:].copy()
    labels[:, :2] = -1
    jb = {"tokens": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.from_numpy(toks[:, :-1]),
          "labels": torch.from_numpy(labels)}
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: JLM(jcfg).loss(p, jb), has_aux=True))(jp)
    tl, tm, tg = loss_and_grads(LM(tcfg), tp, tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(tm["aux_loss"]), float(jm["aux_loss"]),
                               rtol=1e-5)
    want = dict(leaves(jax.tree_util.tree_map(np.asarray, jg)))
    got = dict(leaves(tg))
    assert got.keys() == want.keys()
    for path, w in want.items():
        top = float(np.abs(w).max())
        np.testing.assert_allclose(got[path].numpy(), w, rtol=0,
                                   atol=1e-4 * max(top, 1e-30),
                                   err_msg="/".join(path))
    assert float(np.abs(want[("stack", "0_attn", "mlp", "router")]).max()) > 0


@pytest.mark.parametrize("setting", [{"REPRO_REMAT_POLICY": "dots"},
                                     {"REPRO_REMAT_GROUP": "2"}])
def test_remat_settings_give_equal_gradients(monkeypatch, setting):
    """Each remat switch recomputes other work, never other numbers, with
    the aux loss carried through the checkpoints: deepseek's loss and
    every gradient leaf bit-equal to "full" (two stacked MoE layers)."""
    cfg = tcfgs.get_smoke_config("deepseek-v3-671b")
    assert cfg.layer_plan().n_super == 2
    params = init_params(cfg, device="cpu")
    toks = torch.from_numpy(_tokens(cfg.vocab_size, (2, 16), seed=5))
    batch = {"tokens": toks, "labels": toks}
    for k in ("REPRO_REMAT_POLICY", "REPRO_REMAT_GROUP"):
        monkeypatch.delenv(k, raising=False)
    l0, m0, g0 = loss_and_grads(LM(cfg), params, batch)
    for k, v in setting.items():
        monkeypatch.setenv(k, v)
    l1, m1, g1 = loss_and_grads(LM(cfg), params, batch)
    assert float(l1) == float(l0) and float(m1["aux_loss"]) > 0
    assert float(m1["aux_loss"]) == float(m0["aux_loss"])
    for (path, a), (_, b) in zip(leaves(g0), leaves(g1)):
        assert torch.equal(a, b), "/".join(path)


# --- serving -------------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_matches_reference_engine_greedy(arch):
    """The port's engine gives the reference engine's greedy tokens (float32
    smoke configs; 3 requests on 2 slots, so a freed lane takes a new
    request and the MLA latent is spliced into it)."""
    (jcfg, jp), (tcfg, tp) = _pair(arch, dtype="float32")
    prompts = [[5, 9, 2, 7], [11, 3, 8, 1, 4, 6], [4, 4, 6]]
    new = 6
    jeng = JEngine(jcfg, jp, batch_slots=2, max_len=64)
    teng = ServingEngine(tcfg, tp, batch_slots=2, max_len=64)
    for rid, pr in enumerate(prompts):
        jeng.submit(JRequest(rid=rid, prompt=pr, max_new_tokens=new))
        teng.submit(Request(rid=rid, prompt=pr, max_new_tokens=new))
    jdone = sorted(jeng.run_to_completion(), key=lambda r: r.rid)
    tdone = sorted(teng.run_to_completion(), key=lambda r: r.rid)
    assert [r.out_tokens for r in tdone] == [r.out_tokens for r in jdone]
    assert all(len(r.out_tokens) == new for r in tdone)


def test_engine_splices_the_latent_lane_first():
    """A prefilled MLA cache spliced into a lane of the batch cache: the
    lane's latent (prefix: lane first; stack: layer, then lane) is the
    prefill's, every other lane untouched."""
    cfg = dataclasses.replace(tcfgs.get_smoke_config("deepseek-v3-671b"),
                              dtype="float32")
    params = init_params(cfg, device="cpu")
    eng = ServingEngine(cfg, params, batch_slots=3, max_len=16)
    before = {p: t.clone() for p, t in leaves(eng.cache)}
    one, _ = eng.model.prefill(eng.params, {"tokens": torch.tensor(
        [[3, 1, 4, 1, 5]])}, max_len=16)
    eng._splice_slot(1, one)
    pre = eng.cache["prefix"]["0_attn"]["latent"]
    stk = eng.cache["stack"]["0_attn"]["latent"]
    assert pre.shape == (3, 16, cfg.mla.cache_dim)
    assert stk.shape == (2, 3, 16, cfg.mla.cache_dim)
    assert torch.equal(pre[1], one["prefix"]["0_attn"]["latent"][0])
    assert torch.equal(stk[:, 1], one["stack"]["0_attn"]["latent"][:, 0])
    assert float(pre[1, :5].abs().max()) > 0 and not pre[1, 5:].any()
    for lane in (0, 2):
        assert torch.equal(pre[lane], before[("prefix", "0_attn",
                                              "latent")][lane])
        assert torch.equal(stk[:, lane], before[("stack", "0_attn",
                                                 "latent")][:, lane])
    assert int(eng.cache["pos"][1]) == 5
