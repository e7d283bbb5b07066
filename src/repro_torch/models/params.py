"""Parameter templates, init and counts — one source of truth.

Every block kind declares its parameters once as ``ParamSpec``s, in the
reference's tree layout (``embed``, ``final_norm``, ``head`` and the
repeated super-blocks stacked on a leading layer axis under ``stack``).
From the same template tree come (a) real initialized tensors
(:func:`init_params`, from an explicit ``torch.Generator``), (b) exact
parameter counts (:func:`param_counts`), and (c) the shapes
``repro_torch.convert.lm_params_from_numpy`` checks a carried-over tree
against.  The port has the attention block (GQA or DeepSeek-V3's MLA,
with a dense MLP or a mixture of experts) and the recurrent blocks
(RG-LRU, mLSTM, sLSTM); encoder-decoder and frontend configs raise
``NotImplementedError`` until their slices land (``ROADMAP.md``).
Sharding specs wait for the distributed port.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch.models.config import ModelConfig, torch_dtype

__all__ = ["ParamSpec", "model_templates", "init_params", "param_counts",
           "compute_params", "map_tree", "leaves"]


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    init: str = "fan_in"      # fan_in | normal02 | zeros | ones | lru_lambda
    dtype: str | None = None  # override config.param_dtype


def map_tree(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` applied leaf by leaf over nested dicts of the same keys."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def leaves(tree: Any, path: tuple[str, ...] = ()):
    """(path, leaf) over nested dicts, keys in sorted order at every level
    (the order of ``jax.tree_util.tree_leaves``)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], path + (k,))
    else:
        yield path, tree


def _unported(cfg: ModelConfig) -> str | None:
    if cfg.is_encdec:
        return "encoder-decoder"
    if cfg.frontend is not None:
        return f"the {cfg.frontend} frontend"
    return None


def check_ported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a config the port cannot run."""
    what = _unported(cfg)
    if what is not None:
        raise NotImplementedError(
            f"{cfg.name}: {what} is not ported yet; see ROADMAP.md")


# --- per-kind templates --------------------------------------------------------


def _norm(d: int) -> ParamSpec:
    return ParamSpec((d,), "ones")


def _mlp_templates(cfg: ModelConfig, dense: bool) -> dict[str, ParamSpec]:
    """The dense MLP, or (a MoE config's block that is not ``dense``) the
    router, the routed experts stacked on a leading expert axis and the
    shared experts as one MLP of their summed width."""
    d = cfg.d_model
    if cfg.moe is not None and not dense:
        m = cfg.moe
        fe, fs = m.d_expert, (m.d_shared or m.d_expert) * max(m.n_shared, 1)
        t = {
            "router": ParamSpec((d, m.n_routed), "normal02"),
            "we_in": ParamSpec((m.n_routed, d, fe)),
            "we_gate": ParamSpec((m.n_routed, d, fe)),
            "we_out": ParamSpec((m.n_routed, fe, d)),
        }
        if m.n_shared:
            t.update({"ws_in": ParamSpec((d, fs)),
                      "ws_gate": ParamSpec((d, fs)),
                      "ws_out": ParamSpec((fs, d))})
        return t
    f = cfg.d_ff
    t = {"w_in": ParamSpec((d, f)), "w_out": ParamSpec((f, d))}
    if cfg.mlp_kind in ("swiglu", "geglu"):
        t["w_gate"] = ParamSpec((d, f))
    return t


def _attn_templates(cfg: ModelConfig) -> dict[str, ParamSpec]:
    d, h, hk, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    if cfg.mla is not None:
        m = cfg.mla
        return {
            "w_dq": ParamSpec((d, m.q_lora_rank)),
            "q_norm": _norm(m.q_lora_rank),
            "w_uq": ParamSpec((m.q_lora_rank, h * m.qk_head_dim)),
            "w_dkv": ParamSpec((d, m.kv_lora_rank + m.qk_rope_head_dim)),
            "kv_norm": _norm(m.kv_lora_rank),
            "w_uk": ParamSpec((m.kv_lora_rank, h * m.qk_nope_head_dim)),
            "w_uv": ParamSpec((m.kv_lora_rank, h * m.v_head_dim)),
            "w_o": ParamSpec((h * m.v_head_dim, d)),
        }
    t = {
        "w_q": ParamSpec((d, h * hd)),
        "w_k": ParamSpec((d, hk * hd)),
        "w_v": ParamSpec((d, hk * hd)),
        "w_o": ParamSpec((h * hd, d)),
    }
    if cfg.attn_bias:
        t.update({
            "b_q": ParamSpec((h * hd,), "zeros"),
            "b_k": ParamSpec((hk * hd,), "zeros"),
            "b_v": ParamSpec((hk * hd,), "zeros"),
        })
    return t


def _rglru_templates(cfg: ModelConfig) -> dict[str, ParamSpec]:
    d = cfg.d_model
    w = cfg.lru_width or d
    return {
        "w_y": ParamSpec((d, w)),
        "w_x": ParamSpec((d, w)),
        "conv_w": ParamSpec((cfg.conv1d_width, w), "normal02"),
        "conv_b": ParamSpec((w,), "zeros"),
        "w_a": ParamSpec((w, w)),
        "b_a": ParamSpec((w,), "zeros"),
        "w_i": ParamSpec((w, w)),
        "b_i": ParamSpec((w,), "zeros"),
        "lam": ParamSpec((w,), "lru_lambda"),
        "w_ro": ParamSpec((w, d)),
    }


def _mlstm_templates(cfg: ModelConfig) -> dict[str, ParamSpec]:
    """xLSTM mLSTM block: pf=2 up-projection, conv, matrix-memory cell."""
    d = cfg.d_model
    di = 2 * d
    h = cfg.n_heads
    return {
        "w_up": ParamSpec((d, di)),
        "w_gate_up": ParamSpec((d, di)),
        "conv_w": ParamSpec((cfg.conv1d_width, di), "normal02"),
        "conv_b": ParamSpec((di,), "zeros"),
        "w_q": ParamSpec((di, di)),
        "w_k": ParamSpec((di, di)),
        "w_v": ParamSpec((di, di)),
        "w_if": ParamSpec((di, h), "normal02"),
        "b_if": ParamSpec((h,), "zeros"),
        "w_ff": ParamSpec((di, h), "normal02"),
        "b_ff": ParamSpec((h,), "zeros"),
        "skip_scale": ParamSpec((di,), "ones"),
        "w_down": ParamSpec((di, d)),
    }


def _slstm_templates(cfg: ModelConfig) -> dict[str, ParamSpec]:
    """xLSTM sLSTM block: scalar memory, block-diagonal recurrence, pf-4/3
    FFN."""
    d = cfg.d_model
    h = cfg.n_heads
    hd = d // h
    f = ((4 * d // 3) + 127) // 128 * 128
    t: dict[str, ParamSpec] = {}
    for g in ("i", "f", "z", "o"):
        t[f"w_{g}"] = ParamSpec((d, d))
        t[f"r_{g}"] = ParamSpec((h, hd, hd))
        t[f"b_{g}"] = ParamSpec((d,), "zeros")
    t["ffn_in"] = ParamSpec((d, f))
    t["ffn_gate"] = ParamSpec((d, f))
    t["ffn_out"] = ParamSpec((f, d))
    return t


def block_templates(cfg: ModelConfig, kind: str,
                    dense: bool) -> dict[str, Any]:
    """One block of ``kind``: attention, RG-LRU, mLSTM or sLSTM
    (``check_ported`` rules out the rest).  An attention block of a MoE
    config takes the experts unless ``dense`` (the ``prefix`` section:
    DeepSeek-V3's first ``dense_prefix`` layers)."""
    d = cfg.d_model
    if kind == "attn":
        return {"ln1": _norm(d), "attn": _attn_templates(cfg),
                "ln2": _norm(d), "mlp": _mlp_templates(cfg, dense)}
    if kind == "rglru":
        return {"ln1": _norm(d), "rglru": _rglru_templates(cfg),
                "ln2": _norm(d), "mlp": _mlp_templates(cfg, True)}
    if kind == "mlstm":
        return {"ln1": _norm(d), "mlstm": _mlstm_templates(cfg)}
    if kind == "slstm":
        return {"ln1": _norm(d), "slstm": _slstm_templates(cfg),
                "ln2": _norm(d)}
    raise ValueError(f"unknown block kind {kind!r}")


def _stack(tree: dict, n: int) -> dict:
    """Prepend a layer axis of length n to every leaf spec."""
    return map_tree(lambda s: ParamSpec((n,) + s.shape, s.init, s.dtype),
                    tree)


def model_templates(cfg: ModelConfig) -> dict:
    check_ported(cfg)
    plan = cfg.layer_plan()
    d, vp = cfg.d_model, cfg.padded_vocab
    t: dict[str, Any] = {
        "embed": ParamSpec((vp, d), "normal02"),
        "final_norm": _norm(d),
    }
    if not cfg.tie_embeddings:
        t["head"] = ParamSpec((vp, d), "normal02")
    if plan.prefix:
        t["prefix"] = {f"{i}_{k}": block_templates(cfg, k, dense=True)
                       for i, k in enumerate(plan.prefix)}
    if plan.n_super:
        t["stack"] = _stack({f"{i}_{k}": block_templates(cfg, k, dense=False)
                             for i, k in enumerate(plan.super_block)},
                            plan.n_super)
    if plan.tail:
        t["tail"] = {f"{i}_{k}": block_templates(cfg, k, dense=False)
                     for i, k in enumerate(plan.tail)}
    return t


# --- materialization ---------------------------------------------------------------


# float32 elements drawn at once (256 MiB): a larger leaf is drawn in
# pieces of its flattened elements, so that initializing a model takes its
# weights plus one piece of float32 draw, never a whole leaf in float32
# (qwen2.5-32b's stacked w_in is 36 GB of it)
_DRAW_ELEMENTS = 1 << 26


def _init_leaf(spec: ParamSpec, generator: torch.Generator,
               dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    if spec.init == "lru_lambda":
        # a = exp(-8 * softplus(lam)) in [0.9, 0.999] at init (Griffin A.2)
        u = torch.empty(spec.shape, dtype=torch.float32, device=device)
        u.uniform_(0.9 ** 2, 0.999 ** 2, generator=generator)
        return torch.log(torch.expm1(-torch.log(u) / (2.0 * 8.0))).to(dtype)
    if spec.init == "normal02":
        std = 0.02
    else:  # fan_in: std = 1/sqrt(fan_in), fan_in = second-to-last dim
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        std = 1.0 / math.sqrt(max(fan_in, 1))
    out = torch.empty(spec.shape, dtype=dtype, device=device)
    flat = out.view(-1)
    for i in range(0, flat.numel(), _DRAW_ELEMENTS):
        piece = flat[i:i + _DRAW_ELEMENTS]
        piece.copy_(torch.randn(piece.shape, generator=generator,
                                dtype=torch.float32,
                                device=device).mul_(std))
    return out


def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                device: str | torch.device = "cuda") -> dict:
    """Random parameters from ``generator`` (a seed-0 generator on
    ``device`` when None), in the config's ``param_dtype``.  The draws are
    torch's, not ``jax.random``'s: to compute what the reference computes,
    carry its parameters over with ``convert.lm_params_from_numpy``."""
    device = torch.device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    dtype = torch_dtype(cfg.param_dtype)
    return map_tree(
        lambda s: _init_leaf(s, generator,
                             torch_dtype(s.dtype) if s.dtype else dtype,
                             device),
        model_templates(cfg))


# weights the reference casts to the activation dtype on every use
# (``w.astype(x.dtype)``): the attention, MLA, MLP and expert weights, the
# router, and every recurrent weight but RG-LRU's ``lam``; norm scales
# (MLA's ``q_norm`` and ``kv_norm`` among them) and ``lam`` it reads in
# float32
_MATMUL_KEYS = frozenset({
    "w_q", "w_k", "w_v", "w_o", "b_q", "b_k", "b_v",
    "w_in", "w_gate", "w_out", "embed", "head",
    # MoE
    "router", "we_in", "we_gate", "we_out", "ws_in", "ws_gate", "ws_out",
    # MLA
    "w_dq", "w_uq", "w_dkv", "w_uk", "w_uv",
    # RG-LRU
    "w_y", "w_x", "conv_w", "conv_b", "w_a", "b_a", "w_i", "b_i", "w_ro",
    # mLSTM
    "w_up", "w_gate_up", "w_if", "b_if", "w_ff", "b_ff", "skip_scale",
    "w_down",
    # sLSTM
    "w_f", "w_z", "r_i", "r_f", "r_z", "r_o", "b_f", "b_z", "b_o",
    "ffn_in", "ffn_gate", "ffn_out"})


def compute_params(cfg: ModelConfig, params: dict) -> dict:
    """The tree a forward reads: every weight the reference casts to the
    activation dtype on each call (``.astype(x.dtype)``) cast once here;
    norm scales, which it reads in float32, left as they are.  The numbers
    are the same; what it saves is a copy of every weight on every decode
    step (3.3 GB of bf16 at stablelm-1.6b's full width)."""
    act = cfg.activation_dtype

    def walk(node: Any, key: str | None) -> Any:
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        return node.to(act) if key in _MATMUL_KEYS else node

    return walk(params, None)


def param_counts(cfg: ModelConfig) -> tuple[int, int]:
    """(total, active-per-token) parameter counts from the template tree:
    a token reads ``top_k`` of a MoE layer's ``n_routed`` experts, so each
    routed-expert leaf counts ``n * (n_routed - top_k) // n_routed`` of its
    n parameters as inactive (equal counts for the dense models)."""
    total = inactive = 0
    for path, spec in leaves(model_templates(cfg)):
        n = math.prod(spec.shape)
        total += n
        if cfg.moe is not None and path[-1] in ("we_in", "we_gate",
                                                "we_out"):
            m = cfg.moe
            inactive += n * (m.n_routed - m.top_k) // m.n_routed
    return total, total - inactive
