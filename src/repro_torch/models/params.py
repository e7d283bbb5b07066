"""Parameter templates, init and counts — one source of truth.

Every block kind declares its parameters once as ``ParamSpec``s, in the
reference's tree layout (``embed``, ``final_norm``, ``head`` and the
repeated super-blocks stacked on a leading layer axis under ``stack``).
From the same template tree come (a) real initialized tensors
(:func:`init_params`, from an explicit ``torch.Generator``), (b) exact
parameter counts (:func:`param_counts`), (c) the shapes
``repro_torch.convert.lm_params_from_numpy`` checks a carried-over tree
against, (d) ``meta`` tensors standing in for the parameters
(:func:`param_shape_structs`, for the shape-only dry run) and (e) the
partition-spec trees (:func:`param_pspecs`) that
``repro_torch.distributed.sharding`` maps onto a device mesh.  The
blocks are the reference's: attention (GQA or DeepSeek-V3's MLA, with a
dense MLP or a mixture of experts; an
encoder-decoder config's decoder blocks add ``ln_x`` and a GQA
cross-attention ``xattn``), and the recurrent RG-LRU, mLSTM and sLSTM.
An encoder-decoder config adds the ``encoder`` (a stack of dense
attention blocks and its ``final_norm``), and a config with a frontend
(audio frames or vision patches) its linear ``frontend.adapter``.

Sharding convention (mesh axes ``pod``/``data``/``model``), the
reference's: each leaf's ``pspec`` names one logical axis (or None) per
dim.  Vocab tables shard the padded vocab over ``model``; attention and
MLP follow Megatron TP (column-parallel in, row-parallel out); MoE
experts shard the expert dim (``ep``) or each expert's ffn dim (``tp``);
recurrent inner widths shard over ``model`` when divisible (xlstm-125m's
mLSTM replicates).  A spec is plain data, a tuple of axis names or None
per dim, so that it compares leaf for leaf with the reference's
``PartitionSpec``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch.models.config import ModelConfig, torch_dtype

__all__ = ["ParamSpec", "model_templates", "init_params", "param_counts",
           "compute_params", "map_tree", "leaves", "param_shape_structs",
           "param_pspecs"]


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    init: str = "fan_in"      # fan_in | normal02 | zeros | ones | lru_lambda
    dtype: str | None = None  # override config.param_dtype
    # one logical mesh axis (or None) per dim; keyword only, so that the
    # positional (shape, init, dtype) keep their meaning
    pspec: tuple[Any, ...] | None = dataclasses.field(default=None,
                                                      kw_only=True)


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


# --- per-kind templates --------------------------------------------------------


def _norm(d: int) -> ParamSpec:
    return ParamSpec((d,), "ones", pspec=(None,))


def _mlp_templates(cfg: ModelConfig, dense: bool) -> dict[str, ParamSpec]:
    """The dense MLP, or (a MoE config's block that is not ``dense``) the
    router, the routed experts stacked on a leading expert axis and the
    shared experts as one MLP of their summed width."""
    d = cfg.d_model
    if cfg.moe is not None and not dense:
        m = cfg.moe
        fe, fs = m.d_expert, (m.d_shared or m.d_expert) * max(m.n_shared, 1)
        if m.shard_mode == "ep":
            e_in, e_out = ("model", None, None), ("model", None, None)
        else:  # tp: shard each expert's ffn dim
            e_in, e_out = (None, None, "model"), (None, "model", None)
        t = {
            "router": ParamSpec((d, m.n_routed), "normal02",
                                pspec=(None, None)),
            "we_in": ParamSpec((m.n_routed, d, fe), pspec=e_in),
            "we_gate": ParamSpec((m.n_routed, d, fe), pspec=e_in),
            "we_out": ParamSpec((m.n_routed, fe, d), pspec=e_out),
        }
        if m.n_shared:
            t.update({"ws_in": ParamSpec((d, fs), pspec=(None, "model")),
                      "ws_gate": ParamSpec((d, fs), pspec=(None, "model")),
                      "ws_out": ParamSpec((fs, d), pspec=("model", None))})
        return t
    f = cfg.d_ff
    t = {"w_in": ParamSpec((d, f), pspec=(None, "model")),
         "w_out": ParamSpec((f, d), pspec=("model", None))}
    if cfg.mlp_kind in ("swiglu", "geglu"):
        t["w_gate"] = ParamSpec((d, f), pspec=(None, "model"))
    return t


def _attn_templates(cfg: ModelConfig,
                    cross: bool = False) -> dict[str, ParamSpec]:
    """Self-attention (MLA where the config has it), or with ``cross``
    the GQA projections of a cross-attention, which is never MLA."""
    d, h, hk, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    if cfg.mla is not None and not cross:
        m = cfg.mla
        col, row = (None, "model"), ("model", None)
        return {
            "w_dq": ParamSpec((d, m.q_lora_rank), pspec=(None, None)),
            "q_norm": _norm(m.q_lora_rank),
            "w_uq": ParamSpec((m.q_lora_rank, h * m.qk_head_dim), pspec=col),
            "w_dkv": ParamSpec((d, m.kv_lora_rank + m.qk_rope_head_dim),
                               pspec=(None, None)),
            "kv_norm": _norm(m.kv_lora_rank),
            "w_uk": ParamSpec((m.kv_lora_rank, h * m.qk_nope_head_dim),
                              pspec=col),
            "w_uv": ParamSpec((m.kv_lora_rank, h * m.v_head_dim), pspec=col),
            "w_o": ParamSpec((h * m.v_head_dim, d), pspec=row),
        }
    t = {
        "w_q": ParamSpec((d, h * hd), pspec=(None, "model")),
        "w_k": ParamSpec((d, hk * hd), pspec=(None, "model")),
        "w_v": ParamSpec((d, hk * hd), pspec=(None, "model")),
        "w_o": ParamSpec((h * hd, d), pspec=("model", None)),
    }
    if cfg.attn_bias:
        t.update({
            "b_q": ParamSpec((h * hd,), "zeros", pspec=("model",)),
            "b_k": ParamSpec((hk * hd,), "zeros", pspec=("model",)),
            "b_v": ParamSpec((hk * hd,), "zeros", pspec=("model",)),
        })
    return t


def _rglru_templates(cfg: ModelConfig) -> dict[str, ParamSpec]:
    d = cfg.d_model
    w = cfg.lru_width or d
    sh = "model" if w % 128 == 0 else None
    return {
        "w_y": ParamSpec((d, w), pspec=(None, sh)),
        "w_x": ParamSpec((d, w), pspec=(None, sh)),
        "conv_w": ParamSpec((cfg.conv1d_width, w), "normal02",
                            pspec=(None, sh)),
        "conv_b": ParamSpec((w,), "zeros", pspec=(sh,)),
        "w_a": ParamSpec((w, w), pspec=(None, sh)),
        "b_a": ParamSpec((w,), "zeros", pspec=(sh,)),
        "w_i": ParamSpec((w, w), pspec=(None, sh)),
        "b_i": ParamSpec((w,), "zeros", pspec=(sh,)),
        "lam": ParamSpec((w,), "lru_lambda", pspec=(sh,)),
        "w_ro": ParamSpec((w, d), pspec=(sh, None)),
    }


def _mlstm_templates(cfg: ModelConfig) -> dict[str, ParamSpec]:
    """xLSTM mLSTM block: pf=2 up-projection, conv, matrix-memory cell."""
    d = cfg.d_model
    di = 2 * d
    h = cfg.n_heads
    two, one = (None, None), (None,)   # 125M-class: DP only, replicated
    return {
        "w_up": ParamSpec((d, di), pspec=two),
        "w_gate_up": ParamSpec((d, di), pspec=two),
        "conv_w": ParamSpec((cfg.conv1d_width, di), "normal02", pspec=two),
        "conv_b": ParamSpec((di,), "zeros", pspec=one),
        "w_q": ParamSpec((di, di), pspec=two),
        "w_k": ParamSpec((di, di), pspec=two),
        "w_v": ParamSpec((di, di), pspec=two),
        "w_if": ParamSpec((di, h), "normal02", pspec=two),
        "b_if": ParamSpec((h,), "zeros", pspec=one),
        "w_ff": ParamSpec((di, h), "normal02", pspec=two),
        "b_ff": ParamSpec((h,), "zeros", pspec=one),
        "skip_scale": ParamSpec((di,), "ones", pspec=one),
        "w_down": ParamSpec((di, d), pspec=two),
    }


def _slstm_templates(cfg: ModelConfig) -> dict[str, ParamSpec]:
    """xLSTM sLSTM block: scalar memory, block-diagonal recurrence, pf-4/3
    FFN."""
    d = cfg.d_model
    h = cfg.n_heads
    hd = d // h
    f = ((4 * d // 3) + 127) // 128 * 128
    sh = "model" if f % 128 == 0 else None
    t: dict[str, ParamSpec] = {}
    for g in ("i", "f", "z", "o"):
        t[f"w_{g}"] = ParamSpec((d, d), pspec=(None, None))
        t[f"r_{g}"] = ParamSpec((h, hd, hd), pspec=(None, None, None))
        t[f"b_{g}"] = ParamSpec((d,), "zeros", pspec=(None,))
    t["ffn_in"] = ParamSpec((d, f), pspec=(None, sh))
    t["ffn_gate"] = ParamSpec((d, f), pspec=(None, sh))
    t["ffn_out"] = ParamSpec((f, d), pspec=(sh, None))
    return t


def block_templates(cfg: ModelConfig, kind: str, dense: bool,
                    cross_attn: bool = False) -> dict[str, Any]:
    """One block of ``kind``: attention, RG-LRU, mLSTM or sLSTM.  An
    attention block of a MoE config takes the experts unless ``dense``
    (the ``prefix`` section: DeepSeek-V3's first ``dense_prefix`` layers);
    with ``cross_attn`` (an encoder-decoder's decoder) it adds ``ln_x``
    and the cross-attention ``xattn``."""
    d = cfg.d_model
    if kind == "attn":
        t = {"ln1": _norm(d), "attn": _attn_templates(cfg),
             "ln2": _norm(d), "mlp": _mlp_templates(cfg, dense)}
        if cross_attn:
            t["ln_x"] = _norm(d)
            t["xattn"] = _attn_templates(cfg, cross=True)
        return t
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
    """Prepend a layer axis of length n (never sharded) to every leaf
    spec."""
    return map_tree(lambda s: ParamSpec((n,) + s.shape, s.init, s.dtype,
                                        pspec=(None,) + s.pspec), tree)


def model_templates(cfg: ModelConfig) -> dict:
    plan = cfg.layer_plan()
    d, vp = cfg.d_model, cfg.padded_vocab
    cross = cfg.is_encdec
    t: dict[str, Any] = {
        "embed": ParamSpec((vp, d), "normal02", pspec=("model", None)),
        "final_norm": _norm(d),
    }
    if not cfg.tie_embeddings:
        t["head"] = ParamSpec((vp, d), "normal02", pspec=("model", None))
    if plan.prefix:
        t["prefix"] = {f"{i}_{k}": block_templates(cfg, k, dense=True,
                                                   cross_attn=cross)
                       for i, k in enumerate(plan.prefix)}
    if plan.n_super:
        t["stack"] = _stack({f"{i}_{k}": block_templates(
            cfg, k, dense=False, cross_attn=cross)
            for i, k in enumerate(plan.super_block)}, plan.n_super)
    if plan.tail:
        t["tail"] = {f"{i}_{k}": block_templates(cfg, k, dense=False,
                                                 cross_attn=cross)
                     for i, k in enumerate(plan.tail)}
    if cfg.is_encdec:
        enc = {"0_attn": block_templates(cfg, "attn", dense=True)}
        t["encoder"] = {"stack": _stack(enc, cfg.encoder_layers),
                        "final_norm": _norm(d)}
    if cfg.frontend is not None:
        t["frontend"] = {"adapter": ParamSpec((d, d), pspec=(None, None))}
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
# (``w.astype(x.dtype)``): the attention (cross-attention too), MLA, MLP
# and expert weights, the router, the frontend's adapter, and every
# recurrent weight but RG-LRU's ``lam``; norm scales
# (MLA's ``q_norm`` and ``kv_norm`` among them) and ``lam`` it reads in
# float32
_MATMUL_KEYS = frozenset({
    "w_q", "w_k", "w_v", "w_o", "b_q", "b_k", "b_v",
    "w_in", "w_gate", "w_out", "embed", "head", "adapter",
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


def param_shape_structs(cfg: ModelConfig) -> dict:
    """The parameter tree as ``meta`` tensors: each leaf's shape and dtype
    (the config's ``param_dtype`` unless the template overrides it), no
    storage."""
    dtype = torch_dtype(cfg.param_dtype)
    return map_tree(
        lambda s: torch.empty(s.shape, device="meta",
                              dtype=torch_dtype(s.dtype) if s.dtype
                              else dtype),
        model_templates(cfg))


def param_pspecs(cfg: ModelConfig, *, fsdp_size: int = 0,
                 tp_size: int = 16) -> dict:
    """The partition-spec tree: per leaf a tuple of one axis name (or None)
    per dim, the reference's ``param_pspecs`` as plain data.

    ``model`` is dropped where ``tp_size`` does not divide its dim.
    ``fsdp_size`` > 0 (the bf16 configs of 30B and more) puts ``data`` on
    each leaf's largest still-free dim that ``fsdp_size`` divides and that
    is at least ``4 * fsdp_size`` long: ZeRO-3 style, the layer's weights
    are gathered just before use.  The layer axis of a stacked leaf is
    never FSDP-sharded, and FSDP never spans ``pod``.
    """
    def to_pspec(spec: ParamSpec, stacked: bool) -> tuple:
        axes = [None if ax == "model" and dim % tp_size else ax
                for ax, dim in zip(spec.pspec, spec.shape)]
        if fsdp_size:
            cands = [i for i in range(1 if stacked else 0, len(axes))
                     if axes[i] is None and spec.shape[i] % fsdp_size == 0
                     and spec.shape[i] >= 4 * fsdp_size]
            if cands:
                axes[max(cands, key=lambda i: spec.shape[i])] = "data"
        return tuple(axes)

    def walk(node: Any, under_stack: bool) -> Any:
        if isinstance(node, ParamSpec):
            return to_pspec(node, under_stack)
        return {k: walk(v, under_stack or k == "stack")
                for k, v in node.items()}

    return walk(model_templates(cfg), False)


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
