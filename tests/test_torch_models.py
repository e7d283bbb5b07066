"""The port's LM stack and serving engine on the CPU, against the reference.

The reference's ``init_params`` tree is carried over to the port with
``convert.lm_params_from_numpy``, and both packages get the same tokens
(made with numpy from a seed).  The reference runs on the CPU as its own
tests run it: its ``gqa_full`` takes the chunked jnp path; the port's
goes through ``ops.gqa_flash_attention``, whose wrapper takes the plain
version for CPU tensors.  Tolerances, and why:

* float32 (``dtype="float32"`` via ``dataclasses.replace``): the two
  packages sum the same products in different orders (XLA's and torch's
  CPU matmuls; a dense softmax against a chunked one), so logits differ in
  the last float32 bits, amplified through two layers and the vocab
  projection: rtol 1e-4 / atol 1e-5, the bound the port was asked to
  start from, holds;
* bfloat16 (the configs' default): each package rounds its activations to
  bf16 at its own places, so logits may differ by a few bf16 steps: the
  reference's own decode-equivalence bound, rtol/atol 5e-2
  (``tests/test_models.py``);
* greedy tokens and parameter counts: exactly equal.  The engines are
  compared in float32: in bf16 the logits are rounded to bf16 before the
  argmax, and top-two ties are common at that precision (the qwen2 smoke
  model on the prompt [11, 3, 8, 1] gives tokens 40 and 413 the same
  bf16 logit, 0.46484375, in the reference, whose jitted and eager
  prefills then pick different tokens), so which token wins is not a
  property of either package.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfgs
from repro.models import LM as JLM
from repro.models import init_params as jinit
from repro.models import param_counts as jcounts
from repro.models import layers as jlayers
from repro.runtime import ManualClock as JClock
from repro.runtime import OffloadExecutor as JExecutor
from repro.runtime import OffloadScheduler as JScheduler
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JEngine
from repro_torch import configs as tcfgs
from repro_torch import runtime as trt
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch import serve as tserve
from repro_torch.models import (LM, MoEConfig, compute_params,
                                init_params, param_counts)
from repro_torch.models import layers as tlayers
from repro_torch.models.config import torch_dtype
from repro_torch.serving import Request, ServingEngine

ARCHS = ["stablelm-1.6b", "qwen2-72b", "qwen2.5-32b", "nemotron-4-340b",
         "recurrentgemma-9b", "xlstm-125m"]
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


def _tokens(vocab, shape, seed=7):
    return np.random.default_rng(seed).integers(0, vocab, shape)


def _np(x):
    return np.asarray(x, np.float32)


# --- configs, params, conversion ---------------------------------------------


def test_configs_match_reference_field_for_field():
    for arch in jcfgs.ARCHS:
        for get in ("get_config", "get_smoke_config"):
            j = getattr(jcfgs, get)(arch)
            t = getattr(tcfgs, get)(arch)
            assert dataclasses.asdict(j) == dataclasses.asdict(t), arch
            assert dataclasses.asdict(j.layer_plan()) == \
                dataclasses.asdict(t.layer_plan())
    assert tcfgs.ARCHS == jcfgs.ARCHS
    assert tcfgs.get_smoke_config("stablelm-1.6b").activation_dtype \
        is torch.bfloat16


@pytest.mark.parametrize("arch", ["seamless-m4t-large-v2", "llava-next-34b"])
def test_multimodal_arch_builds_and_runs_its_smoke_loss(arch):
    """The encoder-decoder and vision archs build at full size and run
    their smoke loss (frames or patches beside the tokens); an unknown
    arch is a KeyError."""
    LM(tcfgs.get_config(arch))
    cfg = tcfgs.get_smoke_config(arch)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(_tokens(cfg.vocab_size, (2, 8)))
    batch = {"tokens": toks, "labels": toks}
    if cfg.is_encdec:
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (2, 4, cfg.d_model)).astype(np.float32))
    if cfg.frontend == "vision":
        batch["patches"] = torch.from_numpy(rng.standard_normal(
            (2, cfg.frontend_tokens, cfg.d_model)).astype(np.float32))
    loss, metrics = LM(cfg).loss(init_params(cfg, device="cpu"), batch)
    assert bool(torch.isfinite(loss)) and float(metrics["n_tokens"]) == 16
    with pytest.raises(KeyError):
        tcfgs.get_config("no-such-arch")


@pytest.mark.parametrize("arch", list(jcfgs.ARCHS))
def test_param_counts_equal_reference(arch):
    assert param_counts(tcfgs.get_config(arch)) == \
        jcounts(jcfgs.get_config(arch))
    assert param_counts(tcfgs.get_smoke_config(arch)) == \
        jcounts(jcfgs.get_smoke_config(arch))


@pytest.mark.parametrize("arch,want", [
    ("stablelm-1.6b", 1.6e9), ("qwen2-72b", 72.7e9), ("qwen2.5-32b", 32.8e9),
    ("nemotron-4-340b", 341e9)])
def test_full_param_counts_match_published(arch, want):
    """The published sizes, within the reference's 5 %
    (``tests/test_models.py``)."""
    total, _ = param_counts(tcfgs.get_config(arch))
    assert abs(total - want) / want < 0.05, (arch, total, want)


def test_relu2_tree_converts_without_a_gate():
    """nemotron's squared-ReLU MLP has no ``w_gate``: the reference's tree
    converts, and the port's template has the same keys."""
    (_, jp), (tcfg, tp) = _pair("nemotron-4-340b")
    mlp = tp["stack"]["0_attn"]["mlp"]
    assert "w_gate" not in mlp and set(mlp) == set(
        jp["stack"]["0_attn"]["mlp"])
    assert set(init_params(tcfg, device="cpu")["stack"]["0_attn"]["mlp"]) \
        == set(mlp)


def test_stablelm_full_param_count_exact():
    total, active = param_counts(tcfgs.get_config("stablelm-1.6b"))
    assert total == active == jcounts(jcfgs.get_config("stablelm-1.6b"))[0]


def test_init_params_shapes_dtypes_and_seed():
    cfg = tcfgs.get_smoke_config("qwen2-72b")
    a = init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    b = init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    jp = jinit(jcfgs.get_smoke_config("qwen2-72b"), jax.random.PRNGKey(0))
    shapes = jax.tree_util.tree_map(lambda x: tuple(x.shape), jp)
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), a) == shapes
    torch.testing.assert_close(a["stack"]["0_attn"]["attn"]["w_q"],
                               b["stack"]["0_attn"]["attn"]["w_q"])
    assert torch.all(a["stack"]["0_attn"]["attn"]["b_q"] == 0)
    assert torch.all(a["final_norm"] == 1)
    w = a["stack"]["0_attn"]["mlp"]["w_in"]
    assert w.dtype == torch.float32
    assert abs(float(w.std()) - cfg.d_model ** -0.5) < 0.02
    assert abs(float(a["embed"].std()) - 0.02) < 0.002


def test_compute_params_casts_matmul_weights_once():
    cfg = tcfgs.get_smoke_config("stablelm-1.6b")
    p = init_params(cfg, device="cpu")
    c = compute_params(cfg, p)
    layer = c["stack"]["0_attn"]
    assert layer["attn"]["w_q"].dtype == torch.bfloat16
    assert layer["mlp"]["w_out"].dtype == torch.bfloat16
    assert c["embed"].dtype == c["head"].dtype == torch.bfloat16
    assert layer["ln1"].dtype == c["final_norm"].dtype == torch.float32
    assert c["final_norm"] is p["final_norm"]
    # .to() of an already-cast weight is the tensor itself: no copy
    assert layer["attn"]["w_q"].to(torch.bfloat16) is layer["attn"]["w_q"]


def test_lm_params_from_numpy_checks_keys_and_shapes():
    cfg = tcfgs.get_smoke_config("stablelm-1.6b")
    tree = jax.tree_util.tree_map(
        np.asarray, jinit(jcfgs.get_smoke_config("stablelm-1.6b"),
                          jax.random.PRNGKey(0)))
    bad = dict(tree, head=tree["head"][:-1])
    with pytest.raises(ValueError, match="/head: expected shape"):
        lm_params_from_numpy(bad, cfg, device="cpu")
    missing = {k: v for k, v in tree.items() if k != "final_norm"}
    with pytest.raises(ValueError, match="expected keys"):
        lm_params_from_numpy(missing, cfg, device="cpu")
    bf = jax.tree_util.tree_map(
        lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)), tree)
    got = lm_params_from_numpy(bf, cfg, device="cpu")
    np.testing.assert_array_equal(
        got["embed"].numpy(), np.asarray(bf["embed"], np.float32))


# --- layers ----------------------------------------------------------------------


@pytest.mark.parametrize("pct,theta", [(0.25, 10_000.0), (1.0, 1e6)])
@pytest.mark.parametrize("pos_ndim", [1, 2])
def test_rope_matches_reference(pct, theta, pos_ndim):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 3, 16)).astype(np.float32)
    pos = np.arange(5, 14) if pos_ndim == 1 else \
        rng.integers(0, 500, (2, 9))
    want = jlayers.rope(jnp.asarray(x), jnp.asarray(pos), theta=theta,
                        pct=pct)
    got = tlayers.rope(torch.from_numpy(x), torch.from_numpy(pos),
                       theta=theta, pct=pct)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mlp_kind", ["swiglu", "geglu", "relu2"])
def test_rms_norm_and_mlp_match_reference(mlp_kind):
    jcfg, tcfg = _cfgs("stablelm-1.6b", mlp_kind=mlp_kind, dtype="float32")
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    p = {k: rng.standard_normal(s).astype(np.float32) * 0.1 for k, s in
         (("w_in", (64, 128)), ("w_gate", (64, 128)), ("w_out", (128, 64)))}
    np.testing.assert_allclose(
        tlayers.rms_norm(torch.from_numpy(x), torch.from_numpy(scale)).numpy(),
        _np(jlayers.rms_norm(jnp.asarray(x), jnp.asarray(scale))),
        rtol=1e-5, atol=1e-6)
    got = tlayers.mlp_apply(tcfg, {k: torch.from_numpy(v)
                                   for k, v in p.items()},
                            torch.from_numpy(x))
    want = jlayers.mlp_apply(jcfg, {k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-4, atol=1e-5)


# --- LM: prefill and teacher-forced decode against the reference --------------


def _prefill_and_decode(arch, dtype, window=0, b=2, s=12, steps=3):
    overrides = {"local_window": window}
    if dtype == "float32":
        overrides["dtype"] = "float32"
    (jcfg, jp), (tcfg, tp) = _pair(arch, **overrides)
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
@pytest.mark.parametrize("window", [0, 8])
def test_prefill_and_decode_match_reference_float32(arch, window):
    for want, got in _prefill_and_decode(arch, "float32", window):
        np.testing.assert_allclose(got, want, **F32)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference_bf16(arch):
    for want, got in _prefill_and_decode(arch, "bfloat16"):
        np.testing.assert_allclose(got, want, **BF16)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_matches_full_forward(arch, dtype):
    """Teacher-forced decode == one-shot prefill at the same length, in
    the port alone (the reference's test_decode_matches_full_forward)."""
    tcfg = dataclasses.replace(tcfgs.get_smoke_config(arch), dtype=dtype)
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


def test_every_block_kind_and_input_builds():
    """No config the reference takes is refused: a dense config given
    experts, an encoder, a vision frontend or a recurrent pattern builds,
    and its parameters carry the encoder and the adapter."""
    cfg = tcfgs.get_smoke_config("stablelm-1.6b")
    moe = MoEConfig(n_routed=4, top_k=2, d_expert=32)
    LM(dataclasses.replace(cfg, moe=moe))
    encdec = init_params(dataclasses.replace(cfg, encoder_layers=2,
                                             frontend="audio"), device="cpu")
    assert {"encoder", "frontend"} <= set(encdec)
    assert "xattn" in encdec["stack"]["0_attn"]
    vision = dataclasses.replace(cfg, frontend="vision", frontend_tokens=4)
    LM(vision)
    assert "adapter" in init_params(vision, device="cpu")["frontend"]
    # the recurrent kinds: a hybrid of them builds
    LM(dataclasses.replace(cfg, pattern=("rglru", "attn")))


# --- serving -----------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_matches_reference_engine_greedy(arch):
    """The port's engine gives the reference engine's greedy tokens (the
    smoke configs, as tests/test_system.py serves qwen2; in float32, see
    the module docstring)."""
    (jcfg, jp), (tcfg, tp) = _pair(arch, dtype="float32")
    prompts = [[5, 9, 2, 7], [11, 3, 8, 1], [4, 4, 6]]
    new = 5
    jeng = JEngine(jcfg, jp, batch_slots=2, max_len=64)
    teng = ServingEngine(tcfg, tp, batch_slots=2, max_len=64)
    for rid, pr in enumerate(prompts):
        jeng.submit(JRequest(rid=rid, prompt=pr, max_new_tokens=new))
        teng.submit(Request(rid=rid, prompt=pr, max_new_tokens=new))
    jdone = sorted(jeng.run_to_completion(), key=lambda r: r.rid)
    tdone = sorted(teng.run_to_completion(), key=lambda r: r.rid)
    assert [r.out_tokens for r in tdone] == [r.out_tokens for r in jdone]
    assert all(len(r.out_tokens) == new for r in tdone)


@pytest.mark.parametrize("stop,arch", [
    ("eos", "qwen2-72b"), ("cache_full", "qwen2-72b"),
    ("eos", "deepseek-v3-671b"), ("cache_full", "deepseek-v3-671b")],
    ids=["eos", "cache_full", "mla-eos", "mla-cache_full"])
def test_serving_stops_like_reference_engine(stop, arch):
    """A request ends at its EOS token or when its cache lane is full, as
    in the reference engine (float32 smoke qwen2, as above, and the MLA
    smoke model, whose decode writes its latent at ``pos`` unclamped)."""
    (jcfg, jp), (tcfg, tp) = _pair(arch, dtype="float32")
    prompt, new = [5, 9, 2, 7], 12
    free = JEngine(jcfg, jp, batch_slots=2, max_len=64)
    free.submit(JRequest(rid=0, prompt=prompt, max_new_tokens=new))
    toks = free.run_to_completion()[0].out_tokens
    kw = {"max_len": 64, "eos_id": None}
    if stop == "eos":
        # the first token that did not come before it, so it ends there
        i = next(i for i in range(1, new) if toks[i] not in toks[:i])
        kw["eos_id"] = toks[i]
        want_len = i + 1
    else:
        kw["max_len"] = 10
        want_len = None
    jeng = JEngine(jcfg, jp, batch_slots=2, **kw)
    teng = ServingEngine(tcfg, tp, batch_slots=2, **kw)
    jeng.submit(JRequest(rid=0, prompt=prompt, max_new_tokens=new))
    teng.submit(Request(rid=0, prompt=prompt, max_new_tokens=new))
    jout = jeng.run_to_completion()[0].out_tokens
    (treq,) = teng.run_to_completion()
    assert treq.done and treq.out_tokens == jout
    assert len(jout) < new and len(jout) == (want_len or len(jout))
    assert treq.out_tokens == toks[:len(jout)]


def test_serving_matches_offline_greedy():
    """Engine continuous batching == offline prefill + greedy decode, in
    the port alone (tests/test_system.py's test)."""
    cfg = tcfgs.get_smoke_config("qwen2-72b")
    params = init_params(cfg, device="cpu")
    model = LM(cfg)
    cparams = compute_params(cfg, params)
    prompts = [[5, 9, 2, 7], [11, 3, 8, 1]]
    new = 5
    offline = []
    for pr in prompts:
        cache, logits = model.prefill(cparams, {"tokens": torch.tensor([pr])},
                                      max_len=64)
        toks = [int(torch.argmax(logits[0]))]
        for _ in range(new - 1):
            lg, cache = model.decode_step(cparams, cache,
                                          torch.tensor([[toks[-1]]]))
            toks.append(int(torch.argmax(lg[0])))
        offline.append(toks)
    engine = ServingEngine(cfg, params, batch_slots=2, max_len=64)
    for rid, pr in enumerate(prompts):
        engine.submit(Request(rid=rid, prompt=pr, max_new_tokens=new))
    done = sorted(engine.run_to_completion(), key=lambda r: r.rid)
    assert [r.out_tokens for r in done] == offline


def test_engine_polls_scheduler_across_decode_steps_like_reference():
    """With an OffloadScheduler as the offload hook, a partially filled aux
    group rides across decode steps and releases as ONE crossing once due,
    in both packages (tests/test_scheduler.py's serving-hook test)."""
    (jcfg, jp), (tcfg, tp) = _pair("stablelm-1.6b")
    imgs = [np.random.default_rng(9 + i).random((8, 8), dtype=np.float32)
            for i in range(3)]
    runs = []
    for pkg in ("reference", "port"):
        if pkg == "reference":
            clk = JClock()
            ex = JExecutor(max_batch=8, default_backend="host", clock=clk)
            sched = JScheduler(ex, deadline_s=0.5, clock=clk)
            engine = JEngine(jcfg, jp, batch_slots=2, max_len=32,
                             offload=sched)
            engine.submit(JRequest(rid=0, prompt=[1, 2, 3],
                                   max_new_tokens=4))
            aux = [jnp.asarray(im) for im in imgs]
        else:
            clk = trt.ManualClock()
            ex = trt.OffloadExecutor(max_batch=8, default_backend="host",
                                     clock=clk, device="cpu")
            sched = trt.OffloadScheduler(ex, deadline_s=0.5, clock=clk)
            engine = ServingEngine(tcfg, tp, batch_slots=2, max_len=32,
                                   offload=sched)
            engine.submit(Request(rid=0, prompt=[1, 2, 3],
                                  max_new_tokens=4))
            aux = [torch.from_numpy(im) for im in imgs]
        h0 = engine.submit_aux("fft", aux[0])
        engine.step()
        pending = [engine.pending_aux]
        assert not h0.ready
        clk.advance(0.01)
        engine.submit_aux("fft", aux[1])
        engine.step()
        pending.append(engine.pending_aux)
        clk.advance(0.01)
        engine.submit_aux("fft", aux[2])
        clk.advance(1.0)
        engine.step()
        pending.append(engine.pending_aux)
        ex.drain()
        st = ex.telemetry.stats[("fft", "host")]
        done = engine.run_to_completion(max_steps=8)
        runs.append((pending, st.invocations, st.calls,
                     [r.out_tokens for r in done], _np(h0.get())
                     if pkg == "reference" else h0.get().numpy()))
    (jpend, jinv, jcalls, jtoks, jval), (tpend, tinv, tcalls, ttoks, tval) = \
        runs
    assert tpend == jpend == [1, 2, 0]
    assert (tinv, tcalls) == (jinv, jcalls) == (1, 3)
    assert ttoks == jtoks
    np.testing.assert_allclose(tval, jval, rtol=1e-5,
                               atol=1e-5 * float(np.abs(jval).max()))


def test_serve_cli_runs_on_cpu(capsys):
    done = tserve.main(["--device", "cpu", "--requests", "3",
                        "--max-new", "3", "--slots", "2"])
    assert sorted(r.rid for r in done) == [0, 1, 2]
    assert all(len(r.out_tokens) == 3 for r in done)
    assert "3 requests, 9 tokens" in capsys.readouterr().out


def test_serve_cli_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tserve.main(["--requests", "1"])


def test_activation_dtype_names():
    assert torch_dtype("float32") is torch.float32
    with pytest.raises(ValueError):
        torch_dtype("float8")
