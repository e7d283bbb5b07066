"""The encoder-decoder and vision families on the CPU, against the reference.

seamless-m4t-large-v2 (24 encoder + 24 decoder layers; every decoder
block cross-attends to the encoded frames) and llava-next-34b (576 vision
patches before the text tokens) at their smoke sizes.  The reference's
``init_params`` tree is carried over with ``convert.lm_params_from_numpy``;
tokens, frames and patches are made with numpy from a seed and fed to
both packages.  The reference's attention takes its chunked jnp path; the
port's goes through ``ops.gqa_flash_attention``, whose wrapper takes the
plain version for CPU tensors (cross-attention at Lq != Lk, and decode's
cross-attention at Lq = 1, included).  Tolerances are those of
``tests/test_torch_models.py``, and why: float32 at rtol 1e-4 / atol
1e-5 (summation order only), bfloat16 at the reference's decode bound
5e-2 (each package rounds at its own places), parameter counts exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfgs
from repro.models import LM as JLM
from repro.models import attention as jattn
from repro.models import init_params as jinit
from repro_torch import configs as tcfgs
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels import ops
from repro_torch.models import LM, compute_params, init_params, param_counts
from repro_torch.models import attention as tattn
from repro_torch.models.params import leaves, map_tree
from repro_torch.serving import ServingEngine

ARCHS = ["seamless-m4t-large-v2", "llava-next-34b"]
F32 = dict(rtol=1e-4, atol=1e-5)
BF16 = dict(rtol=5e-2, atol=5e-2)


def _cfgs(arch, **overrides):
    j = dataclasses.replace(jcfgs.get_smoke_config(arch), **overrides)
    t = dataclasses.replace(tcfgs.get_smoke_config(arch), **overrides)
    return j, t


def _pair(arch, seed=0, **overrides):
    """(reference cfg, params) and (port cfg, params) holding the same
    weights."""
    jcfg, tcfg = _cfgs(arch, **overrides)
    jp = jinit(jcfg, jax.random.PRNGKey(seed))
    tp = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                              device="cpu")
    return (jcfg, jp), (tcfg, tp)


def _np(x):
    return np.asarray(x, np.float32)


def _extra(cfg, b, s, seed=11):
    """The non-token inputs of ``cfg`` at batch b and s text tokens, as
    the reference's tests shape them: frames (b, s // 2, d) for the
    encoder-decoder, patches (b, frontend_tokens, d) for vision."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.is_encdec:
        out["frames"] = rng.standard_normal(
            (b, s // 2, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "vision":
        out["patches"] = rng.standard_normal(
            (b, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    return out


def _batches(cfg, tokens, extra, labels=None):
    """The same batch for the reference (jnp, int32 tokens) and the port
    (torch, int64 tokens)."""
    jb = {"tokens": jnp.asarray(tokens, jnp.int32)}
    tb = {"tokens": torch.from_numpy(np.asarray(tokens, np.int64))}
    if labels is not None:
        jb["labels"] = jnp.asarray(labels, jnp.int32)
        tb["labels"] = torch.from_numpy(np.asarray(labels, np.int64))
    for k, v in extra.items():
        jb[k] = jnp.asarray(v)
        tb[k] = torch.from_numpy(v)
    return jb, tb


# --- configs, counts, conversion ---------------------------------------------


def test_every_arch_is_ported():
    assert tuple(tcfgs.ARCHS) == tuple(jcfgs.ARCHS)
    assert set(tcfgs.TOKEN_ARCHS) == set(tcfgs.ARCHS) - set(ARCHS)
    assert not any(tcfgs.get_config(a).tokens_only for a in ARCHS)
    for arch in tcfgs.ARCHS:
        LM(tcfgs.get_config(arch))
        init_params(tcfgs.get_smoke_config(arch), device="cpu")


@pytest.mark.parametrize("arch,want", [
    ("seamless-m4t-large-v2", 2_039_605_248),
    ("llava-next-34b", 34_462_317_568)])
def test_full_param_counts(arch, want):
    total, active = param_counts(tcfgs.get_config(arch))
    assert total == active == want


@pytest.mark.parametrize("arch", ARCHS)
def test_conversion_carries_encoder_cross_attention_and_frontend(arch):
    """The encoder's stack and final norm, each decoder block's ``ln_x``
    and ``xattn`` (GQA), and the frontend's adapter cross over with the
    reference's values; the port's own init has the same tree."""
    (jcfg, jp), (tcfg, tp) = _pair(arch)
    jl = dict(leaves(jax.tree_util.tree_map(np.asarray, jp)))
    tl = dict(leaves(tp))
    assert jl.keys() == tl.keys()
    for path, want in jl.items():
        np.testing.assert_array_equal(tl[path].numpy(), want,
                                      err_msg="/".join(path))
    own = {path: tuple(t.shape)
           for path, t in leaves(init_params(tcfg, device="cpu"))}
    assert own == {path: w.shape for path, w in jl.items()}
    assert ("frontend", "adapter") in tl
    if tcfg.is_encdec:
        assert ("encoder", "final_norm") in tl
        assert ("encoder", "stack", "0_attn", "attn", "w_q") in tl
        assert tl[("stack", "0_attn", "xattn", "w_k")].shape == \
            (tcfg.n_layers, tcfg.d_model, tcfg.n_kv_heads * tcfg.head_dim_)
        assert ("stack", "0_attn", "ln_x") in tl
        assert not any(p[0] == "encoder" and "xattn" in p for p in tl)
    else:
        assert not any("xattn" in p or p[0] == "encoder" for p in tl)


def test_compute_params_casts_adapter_and_cross_attention():
    cfg = tcfgs.get_smoke_config("seamless-m4t-large-v2")
    c = compute_params(cfg, init_params(cfg, device="cpu"))
    assert c["frontend"]["adapter"].dtype == torch.bfloat16
    assert c["stack"]["0_attn"]["xattn"]["w_o"].dtype == torch.bfloat16
    assert c["encoder"]["stack"]["0_attn"]["mlp"]["w_in"].dtype == \
        torch.bfloat16
    assert c["stack"]["0_attn"]["ln_x"].dtype == torch.float32
    assert c["encoder"]["final_norm"].dtype == torch.float32


# --- input_specs -----------------------------------------------------------------


@pytest.mark.parametrize("shape_name", list(jcfgs.SHAPES))
@pytest.mark.parametrize("arch", ["qwen2-72b", *ARCHS])
@pytest.mark.parametrize("with_labels", [None, True, False])
def test_input_specs_equal_reference(arch, shape_name, with_labels):
    """Each input kind's stand-ins (tokens; frames; patches) at every
    shape of ``SHAPES``, as ``tests/test_models.py`` takes them: the
    reference's keys, shapes
    and activation dtypes, on ``meta``, tokens and labels int64 where the
    reference's are int32 (and the total of patches and tokens the cell's
    sequence length, as ``tests/test_models.py`` asserts)."""
    cfg, jcfg = tcfgs.get_config(arch), jcfgs.get_config(arch)
    got = tcfgs.input_specs(cfg, shape_name, with_labels=with_labels)
    want = jcfgs.input_specs(jcfg, shape_name, with_labels=with_labels)
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        assert g.device.type == "meta", k
        assert tuple(g.shape) == tuple(w.shape), k
        if w.dtype == jnp.int32:
            assert g.dtype == torch.int64, k
        else:
            assert str(g.dtype).removeprefix("torch.") == str(w.dtype), k
    sh = tcfgs.SHAPES[shape_name]
    assert tcfgs.input_specs(cfg, sh, with_labels=with_labels).keys() == \
        got.keys()
    if sh.kind != "decode" and cfg.frontend == "vision":
        assert got["tokens"].shape[1] + got["patches"].shape[1] == \
            sh.seq_len


# --- attention ---------------------------------------------------------------------


@pytest.mark.parametrize("lk", [6, 17])
def test_gqa_full_cross_matches_reference(lk):
    """Cross-attention (keys and values from the encoder memory, no RoPE,
    no mask, Lq != Lk), GQA 4 at the llava smoke widths and MHA at
    seamless's, in float32."""
    rng = np.random.default_rng(5)
    for arch in ARCHS:
        (jcfg, jp), (tcfg, tp) = _pair(arch, dtype="float32")
        jl = jp["stack"]["0_attn"]["attn"]
        jl = jax.tree_util.tree_map(lambda a: a[0], jl)
        tl = {k: v[0] for k, v in tp["stack"]["0_attn"]["attn"].items()}
        x = rng.standard_normal((2, 9, tcfg.d_model)).astype(np.float32)
        mem = rng.standard_normal((2, lk, tcfg.d_model)).astype(np.float32)
        want = jattn.gqa_full(jcfg, jl, jnp.asarray(x),
                              cross_kv=jnp.asarray(mem), causal=False,
                              use_rope=False)
        got = tattn.gqa_full(tcfg, tl, torch.from_numpy(x),
                             cross_kv=torch.from_numpy(mem), causal=False,
                             use_rope=False)
        np.testing.assert_allclose(got.numpy(), _np(want), **F32)
        # decode's cross-attention: one query against the whole memory
        want = jattn.gqa_decode_cross(jcfg, jl, jnp.asarray(x[:, :1]),
                                      jnp.asarray(mem))
        got = tattn.gqa_decode_cross(tcfg, tl, torch.from_numpy(x[:, :1]),
                                     torch.from_numpy(mem))
        assert got.shape == (2, 1, tcfg.d_model)
        np.testing.assert_allclose(got.numpy(), _np(want), **F32)


def test_encoder_self_attention_is_non_causal_with_rope():
    """The encoder's attention (``causal=False`` with RoPE at positions
    from 0) equals the reference's; a later frame changes an earlier
    frame's output, as it must without a causal mask."""
    (jcfg, jp), (tcfg, tp) = _pair("seamless-m4t-large-v2", dtype="float32")
    jl = jax.tree_util.tree_map(lambda a: a[0],
                                jp["encoder"]["stack"]["0_attn"]["attn"])
    tl = {k: v[0] for k, v in tp["encoder"]["stack"]["0_attn"]["attn"].items()}
    x = np.random.default_rng(6).standard_normal((2, 8, 64)).astype(
        np.float32)
    want = jattn.gqa_full(jcfg, jl, jnp.asarray(x), causal=False)
    got = tattn.gqa_full(tcfg, tl, torch.from_numpy(x), causal=False)
    np.testing.assert_allclose(got.numpy(), _np(want), **F32)
    y = x.copy()
    y[:, -1] += 1.0
    moved = tattn.gqa_full(tcfg, tl, torch.from_numpy(y), causal=False)
    assert not torch.allclose(moved[:, 0], got[:, 0])


def _recording_attention(monkeypatch):
    """Record (Lq, Lk, causal) of every ``ops.gqa_flash_attention`` call
    the model makes."""
    calls = []
    real = ops.gqa_flash_attention

    def recording(q, k, v, **kw):
        calls.append((q.shape[2], k.shape[2], kw.get("causal", True)))
        return real(q, k, v, **kw)

    monkeypatch.setattr(ops, "gqa_flash_attention", recording)
    return calls


def test_seamless_attention_goes_through_the_kernel_wrapper(monkeypatch):
    """A prefill calls the flash-attention wrapper once per encoder layer
    (non-causal, L frames), once per decoder layer for self-attention
    (causal) and once for cross-attention (Lq tokens, Lk frames); a decode
    step once per decoder layer at Lq = 1 against all frames."""
    cfg = tcfgs.get_smoke_config("seamless-m4t-large-v2")
    params = compute_params(cfg, init_params(cfg, device="cpu"))
    b, s = 2, 12
    extra = _extra(cfg, b, s)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (b, s + 1)))
    calls = _recording_attention(monkeypatch)
    model = LM(cfg)
    cache, _ = model.prefill(params, {"tokens": toks[:, :s], "frames":
                                      torch.from_numpy(extra["frames"])},
                             max_len=s + 4)
    f = s // 2
    assert sorted(calls) == sorted(
        [(f, f, False)] * cfg.encoder_layers
        + [(s, s, True)] * cfg.n_layers + [(s, f, False)] * cfg.n_layers)
    calls.clear()
    model.decode_step(params, cache, toks[:, s:])
    assert calls == [(1, f, False)] * cfg.n_layers


# --- LM against the reference -------------------------------------------------------


def _prefill_and_decode(arch, dtype, b=2, s=12, steps=3):
    overrides = {"dtype": "float32"} if dtype == "float32" else {}
    (jcfg, jp), (tcfg, tp) = _pair(arch, **overrides)
    toks = np.random.default_rng(7).integers(0, 100, (b, s + steps))
    extra = _extra(tcfg, b, s)
    max_len = s + 8 + tcfg.frontend_tokens
    jb, tb = _batches(tcfg, toks[:, :s], extra)
    jm, tm = JLM(jcfg), LM(tcfg)
    jcache, jlg = jax.jit(lambda p, bt: jm.prefill(p, bt, max_len=max_len))(
        jp, jb)
    tparams = compute_params(tcfg, tp)
    tcache, tlg = tm.prefill(tparams, tb, max_len=max_len)
    pairs = [(_np(jlg), tlg.float().numpy())]
    if tcfg.is_encdec:
        pairs.append((_np(jcache["enc_out"]),
                      tcache["enc_out"].float().numpy()))
    else:
        assert "enc_out" not in tcache
    jstep = jax.jit(jm.decode_step)
    for i in range(steps):
        jlg, jcache = jstep(jp, jcache,
                            jnp.asarray(toks[:, s + i][:, None], jnp.int32))
        tlg, tcache = tm.decode_step(
            tparams, tcache, torch.from_numpy(toks[:, s + i][:, None]))
        pairs.append((_np(jlg), tlg.numpy()))
    if tcfg.is_encdec:   # decode carries the encoder memory unchanged
        pairs.append((_np(jcache["enc_out"]),
                      tcache["enc_out"].float().numpy()))
    assert int(tcache["pos"][0]) == s + tcfg.frontend_tokens + steps
    return pairs


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference_float32(arch):
    for want, got in _prefill_and_decode(arch, "float32"):
        np.testing.assert_allclose(got, want, **F32)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference_bf16(arch):
    for want, got in _prefill_and_decode(arch, "bfloat16"):
        np.testing.assert_allclose(got, want, **BF16)


def _loss_pair(arch, dtype, b=2, s=16):
    overrides = {"dtype": "float32"} if dtype == "float32" else {}
    (jcfg, jp), (tcfg, tp) = _pair(arch, **overrides)
    rng = np.random.default_rng(9)
    toks, labels = (rng.integers(0, tcfg.vocab_size, (b, s))
                    for _ in range(2))
    labels[0, :3] = -1
    jb, tb = _batches(tcfg, toks, _extra(tcfg, b, s), labels)
    return (jcfg, jp, jb), (tcfg, tp, tb)


def _with_grad(params):
    return map_tree(lambda t: t.detach().clone().requires_grad_(True),
                    params)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference_float32(arch):
    """``LM.loss`` and its gradient to every parameter against
    ``jax.value_and_grad`` of the reference's, in float32: the loss at
    rtol 1e-4 / atol 1e-5, each leaf within 1e-4 * max|g| (the training
    bound); a vision model's labels are padded over its patches, so only
    text tokens count."""
    (jcfg, jp, jb), (tcfg, tp, tb) = _loss_pair(arch, "float32")
    jm = JLM(jcfg)
    (jloss, jmet), jg = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, jb), has_aux=True))(jp)
    tp = _with_grad(tp)
    tloss, tmet = LM(tcfg).loss(tp, tb)
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), **F32)
    assert float(tmet["n_tokens"]) == float(jmet["n_tokens"]) == \
        float((tb["labels"] >= 0).sum())
    jgl = dict(leaves(jax.tree_util.tree_map(np.asarray, jg)))
    got = dict(leaves(tp))
    assert got.keys() == jgl.keys()
    for path, want in jgl.items():
        top = float(np.abs(want).max())
        np.testing.assert_allclose(got[path].grad.numpy(), want, rtol=0,
                                   atol=1e-4 * max(top, 1e-30),
                                   err_msg="/".join(path))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches_reference_bf16(arch):
    (jcfg, jp, jb), (tcfg, tp, tb) = _loss_pair(arch, "bfloat16")
    jloss, _ = jax.jit(JLM(jcfg).loss)(jp, jb)
    tloss, _ = LM(tcfg).loss(tp, tb)
    np.testing.assert_allclose(float(tloss), float(jloss), **BF16)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_matches_full_forward(arch, dtype):
    """Teacher-forced decode == one-shot prefill at the same length, in
    the port alone (the reference's ``test_decode_matches_full_forward``,
    which runs seamless; llava with its patches too)."""
    tcfg = dataclasses.replace(tcfgs.get_smoke_config(arch), dtype=dtype)
    model = LM(tcfg)
    params = compute_params(tcfg, init_params(tcfg, device="cpu"))
    b, s = 2, 12
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, 100, (b, s + 3)))
    extra = {k: torch.from_numpy(v) for k, v in _extra(tcfg, b, s).items()}
    max_len = s + 8 + tcfg.frontend_tokens
    cache, _ = model.prefill(params, dict(tokens=toks[:, :s], **extra),
                             max_len=max_len)
    for i in range(3):
        lg, cache = model.decode_step(params, cache, toks[:, s + i][:, None])
    _, lg_full = model.prefill(params, dict(tokens=toks[:, :s + 3], **extra),
                               max_len=max_len)
    np.testing.assert_allclose(lg.numpy(), lg_full.numpy(), **BF16)


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_loss_and_grads_finite(arch):
    """The reference's ``test_arch_smoke_train_step`` and
    ``test_arch_smoke_grads_finite`` for the port: bf16 activations,
    float32 masters, every block rematerialized."""
    cfg = tcfgs.get_smoke_config(arch)
    params = _with_grad(init_params(cfg, device="cpu"))
    b, s = 2, 16
    s_text = s - (cfg.frontend_tokens if cfg.frontend == "vision" else 0)
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                              (b, s_text)))
             for k in ("tokens", "labels")}
    batch.update({k: torch.from_numpy(v)
                  for k, v in _extra(cfg, b, s).items()})
    loss, metrics = LM(cfg).loss(params, batch)
    assert loss.shape == () and bool(torch.isfinite(loss))
    assert float(metrics["n_tokens"]) == b * s_text
    loss.backward()
    for path, t in leaves(params):
        assert t.grad is not None and bool(torch.isfinite(t.grad).all()), \
            "/".join(path)


def test_encoder_remat_changes_no_gradient():
    """Checkpointing the encoder's layers (``remat``) gives the same loss
    and gradients as keeping their activations, bit for bit."""
    cfg = dataclasses.replace(tcfgs.get_smoke_config("seamless-m4t-large-v2"),
                              dtype="float32")
    _, (_, tp, tb) = _loss_pair("seamless-m4t-large-v2", "float32")
    out = []
    for remat in (True, False):
        p = _with_grad(tp)
        loss, _ = LM(cfg).loss(p, tb, remat=remat)
        loss.backward()
        out.append((loss.detach(), [t.grad for _, t in leaves(p)]))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_refuses_configs_that_need_more_than_tokens(arch):
    """The serving engine takes token prompts only, as the reference's
    does: it refuses both families when it is built."""
    cfg = tcfgs.get_smoke_config(arch)
    with pytest.raises(ValueError, match="token prompts only"):
        ServingEngine(cfg, init_params(cfg, device="cpu"), max_len=32)
