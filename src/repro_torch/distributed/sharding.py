"""Mesh-aware sharding helpers, over DTensor.

The twin of ``repro.distributed.sharding``.  A partition spec is plain
data (``models.params.param_pspecs``, ``distributed.specs``): one entry
per tensor dim, each an axis name, a tuple of axis names or None.
:func:`logical_to_mesh` drops the names the current mesh does not define,
so that the same model code runs on the single-pod ``(data, model)``
mesh, the multi-pod ``(pod, data, model)`` mesh and tiny test meshes;
:func:`placements` maps a spec to DTensor placements on a mesh, and
:func:`distribute_tree` distributes a params, optimizer-state or batch
tree by its spec tree.

:func:`meta_tree` lays out a tree of ``meta`` shape stand-ins the same
way without data: each leaf becomes a DTensor whose local tensor is the
first device's shard, for the dry run's per-device count over a fake
process group (``distribute_tensor`` would scatter, which a fake group
cannot do).

:func:`split_heads` and :func:`merge_heads` split a projection's heads
over ``model`` and merge them back; where ``model`` does not divide the
heads they run padded (:func:`head_pad`), re-laid out by all-to-alls, as
XLA pads an uneven split.

:func:`split_rows` splits a batch into its microbatches; where the
data devices do not divide a microbatch's rows it runs padded
(:func:`row_pad`), re-laid out by one all-to-all, as XLA pads the
reference's scanned microbatches.  :func:`real_rows` tells the model
which rows are pads, for the one reduction over rows that labels do not
mask (the MoE load-balance loss).

:func:`constrain` is the one entry point the model uses to pin an
activation's layout: the identity on a plain tensor or off a mesh, and a
``redistribute`` to the filtered spec for a DTensor under a mesh.
:func:`shard_devices` places the sharded offload backend's work and has
nothing to do with the mesh.
"""

from __future__ import annotations

import contextlib
import functools
import math
import os
from typing import Any, Iterator, Sequence

import torch
from torch.distributed.tensor import (DTensor, Placement, Replicate,
                                      Shard, distribute_tensor)
from torch.distributed.tensor.experimental import implicit_replication

__all__ = ["constrain", "batch_axes", "current_axis_names",
           "logical_to_mesh", "activation_sharding_mode",
           "constrain_residual", "placements", "distribute_tree",
           "meta_tree", "local_shape", "like_param", "mesh_ops",
           "reshape", "split_heads", "merge_heads", "like_layout",
           "on_local", "row_pad", "split_rows", "real_rows",
           "row_weights",
           "gather_fsdp", "pin_residual", "shard_devices"]


def activation_sharding_mode() -> str:
    """'baseline': the layouts follow the parameters only; 'dp': the
    residual stream is pinned batch-sharded at block boundaries; 'sp':
    batch over the data axes and the sequence over ``model``.  Read from
    ``REPRO_ACT_SHARDING``, as the reference reads it."""
    return os.environ.get("REPRO_ACT_SHARDING", "baseline")


def constrain_residual(x: torch.Tensor) -> torch.Tensor:
    """Pin a (B, S, D) residual-stream tensor between blocks, by
    :func:`activation_sharding_mode` ('dp': batch over the data axes;
    'sp': also the sequence over ``model``).  The identity in 'baseline'
    and when the batch does not divide 32 (the largest dp extent, 2 x
    16)."""
    mode = activation_sharding_mode()
    if mode not in ("dp", "sp") or x.shape[0] % 32 != 0:
        return x
    if mode == "sp" and x.ndim == 3 and x.shape[1] % 16 == 0:
        return constrain(x, ("pod", "data"), "model", None)
    return constrain(x, ("pod", "data"), None, None)


def pin_residual(x: torch.Tensor) -> torch.Tensor:
    """The residual stream (B, S, D) after a residual add, under a mesh
    in the 'baseline' mode: its batch split kept and every other dim
    replicated, the tensor-parallel layout XLA's propagation gives the
    reference there.  DTensor picks each op's layout alone: left
    unpinned it reduce-scatters a row-parallel product into a D split,
    and the next block's products then replicate their work over
    ``model``.  The identity on a plain tensor and in the 'dp' and 'sp'
    modes (``constrain_residual`` pins those at each block's entry)."""
    if not isinstance(x, DTensor) or activation_sharding_mode() != "baseline":
        return x
    return _Pin.apply(x, tuple(like_layout(x, {0: 0})))


class _Pin(torch.autograd.Function):
    """A redistribute whose backward lays the gradient out as the forward
    laid out its result (a partial-sum gradient is summed there), as a
    tensor-parallel residual's gradient is: DTensor's own backward would
    hand the gradient on as a partial sum, and the products behind it
    then gather their weights whole to take it."""

    @staticmethod
    def forward(ctx, x, want):
        ctx.want = list(want)
        if list(x.placements) == ctx.want:
            return x.view_as(x)
        return x.redistribute(x.device_mesh, ctx.want)

    @staticmethod
    def backward(ctx, g):
        if list(g.placements) != ctx.want:
            g = g.redistribute(g.device_mesh, ctx.want)
        return g, None


def current_axis_names() -> tuple[str, ...]:
    from repro_torch.distributed.compat import current_mesh_axis_names
    return current_mesh_axis_names()


def _filter_spec(spec: Any, axes: tuple[str, ...]) -> Any:
    if spec is None:
        return None
    if isinstance(spec, (tuple, list)):
        kept = tuple(a for a in spec if a in axes)
        return kept if kept else None
    return spec if spec in axes else None


def logical_to_mesh(pspec: Sequence) -> tuple | None:
    """``pspec`` without the axis names the current mesh does not define;
    None off a mesh."""
    axes = current_axis_names()
    if not axes:
        return None
    return tuple(_filter_spec(s, axes) for s in pspec)


def placements(spec: Sequence, mesh) -> list[Placement]:
    """DTensor placements of a tensor laid out by ``spec`` on ``mesh``:
    ``Shard(d)`` on every mesh dim that dim d's entry names (a dim over
    ``(pod, data)`` is sharded over both, pod major, as the reference's
    ``PartitionSpec`` splits it), ``Replicate()`` on a mesh dim no entry
    names.  Names the mesh does not define are ignored."""
    out: list[Placement] = [Replicate()] * mesh.ndim
    names = list(mesh.mesh_dim_names)
    for d, entry in enumerate(spec):
        for name in ((entry,) if isinstance(entry, str) else entry or ()):
            if name in names:
                out[names.index(name)] = Shard(d)
    return out


def distribute_tree(tree: Any, specs: Any, mesh) -> Any:
    """Every tensor of ``tree`` (params, optimizer state or a batch, the
    same on every rank) as a DTensor on ``mesh``, laid out by its leaf of
    ``specs``."""
    from repro_torch.models.params import map_tree   # models import us
    return map_tree(lambda t, s: distribute_tensor(t, mesh,
                                                   placements(s, mesh)),
                    tree, specs)


def local_shape(shape: Sequence[int], pl: Sequence[Placement],
                mesh) -> tuple[int, ...]:
    """The first device's shard of a tensor of ``shape`` under ``pl``:
    each sharded dim split by ceiling over each mesh dim that shards it,
    in mesh-dim order, as DTensor's ``Shard`` splits it (the first
    shard is the largest)."""
    out = list(shape)
    for i, p in enumerate(pl):
        if isinstance(p, Shard):
            out[p.dim] = -(-out[p.dim] // mesh.size(i))
    return tuple(out)


def meta_tree(tree: Any, specs: Any, mesh) -> Any:
    """Every tensor of ``tree`` (shape stand-ins on ``meta``) as a DTensor
    on ``mesh`` laid out by its leaf of ``specs`` (None: replicated),
    holding the first device's shard on ``meta``; what is not a tensor is
    kept as it is."""
    from repro_torch.models.params import map_tree   # models import us

    def one(t, spec):
        if not isinstance(t, torch.Tensor):
            return t
        pl = placements(spec or (), mesh)
        local = torch.empty(local_shape(t.shape, pl, mesh), dtype=t.dtype,
                            device="meta")
        return DTensor.from_local(local, mesh, pl, run_check=False,
                                  shape=t.shape, stride=t.stride())

    if specs is None:
        return map_tree(lambda t: one(t, None), tree)
    return map_tree(one, tree, specs)


def gather_fsdp(tree: Any) -> Any:
    """Every DTensor of ``tree`` (a layer's parameters) gathered over the
    mesh dims named ``data`` or ``pod`` that split it, its ``model``
    split kept: the ZeRO-3 all-gather of ``param_pspecs``' FSDP dims just
    before the layer uses them (its backward reduce-scatters the
    gradients back).  Plain tensors, and DTensors no data axis splits,
    are returned as they are."""
    from repro_torch.models.params import map_tree   # models import us

    def one(t):
        if not isinstance(t, DTensor):
            return t
        names = t.device_mesh.mesh_dim_names
        want = [Replicate() if isinstance(p, Shard)
                and names[i] in ("pod", "data") else p
                for i, p in enumerate(t.placements)]
        if want == list(t.placements):
            return t
        return t.redistribute(t.device_mesh, want)

    return map_tree(one, tree)


def like_param(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A gradient laid out as its parameter: a DTensor gradient (Partial
    over the data axes, where the batch was sharded) is redistributed to
    ``p``'s placements, which sums it over them; a plain one is returned
    as it is."""
    if isinstance(g, DTensor) and isinstance(p, DTensor) \
            and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


_MESH_OPS_DEPTH = [0]


@contextlib.contextmanager
def mesh_ops() -> Iterator[None]:
    """Under a current mesh, plain tensors that the model makes for itself
    (RoPE angles, masks, ``arange``s, zeros) join DTensor ops as
    replicated DTensors; they are the same on every rank.  Off a mesh it
    does nothing.  The train and eval steps enter it around forward and
    backward both (a checkpointed block's recompute runs in backward),
    ``LM.prefill`` and ``decode_step`` around their forward; a nested
    entry does nothing (torch's ``implicit_replication`` turns the switch
    off on exit, whatever it was)."""
    from repro_torch.distributed.compat import current_mesh
    if current_mesh() is None or _MESH_OPS_DEPTH[0]:
        yield
        return
    _MESH_OPS_DEPTH[0] += 1
    try:
        with implicit_replication():
            yield
    finally:
        _MESH_OPS_DEPTH[0] -= 1


def constrain(x: torch.Tensor, *spec: Any) -> torch.Tensor:
    """Pin ``x``'s layout to ``spec``: the identity on a plain tensor or
    off a mesh; a DTensor under a mesh is redistributed to the spec
    filtered for that mesh (differentiably).  A dim the mesh dims that
    name it do not divide stays replicated on them (a batch of one row,
    ``long_500k``): DTensor's rules take no uneven split.  (A microbatch
    whose rows the data devices do not divide arrives padded,
    :func:`split_rows`.)"""
    resolved = logical_to_mesh(spec)
    if resolved is None or not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    want = placements(resolved, mesh)
    for d in {p.dim for p in want if isinstance(p, Shard)}:
        split = [i for i, p in enumerate(want) if p == Shard(d)]
        if x.shape[d] % math.prod(mesh.size(i) for i in split):
            for i in split:
                want[i] = Replicate()
    if list(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def reshape(x: torch.Tensor, *shape: int) -> torch.Tensor:
    """``x.reshape(shape)``.  A DTensor whose layout the reshape cannot
    keep (a dim split into factors the mesh does not divide, merged with
    a sharded inner dim, or merged past a split the mesh does not divide
    while a partial sum) is replicated first: its sharded dims other than
    an unchanged leading one are all-gathered and its partial sums
    reduced, and the count of collectives sees it.  DTensor has no rule
    for an uneven split or merge; XLA re-lays such a tensor out as it
    must."""
    if not isinstance(x, DTensor):
        return x.reshape(shape)
    return _Reshape.apply(x, shape)


def _reshape_dtensor(x: DTensor, shape) -> DTensor:
    try:
        return x.reshape(shape)
    except (RuntimeError, NotImplementedError):
        keep = shape and shape[0] == x.shape[0]
        want = [Replicate() if p.is_partial() or p.is_shard()
                and not (keep and type(p) is Shard and p.dim == 0) else p
                for p in x.placements]
        return x.redistribute(x.device_mesh, want).reshape(shape)


class _Reshape(torch.autograd.Function):
    """:func:`reshape` of a DTensor, whose backward reshapes the gradient
    the same way (its placements may differ from the forward's)."""

    @staticmethod
    def forward(ctx, x, shape):
        ctx.shape = tuple(x.shape)
        return _reshape_dtensor(x, shape)

    @staticmethod
    def backward(ctx, g):
        return _reshape_dtensor(g, ctx.shape), None


def head_pad(heads: int, groups: int, m: int) -> list[int]:
    """The padded head order of ``heads`` query heads in ``groups`` groups
    (a group shares one KV head) over ``m`` devices: each group's g heads
    padded to the least g' >= g that makes groups x g' a multiple of m, so
    that padded head j reads KV head j // g' as real head ``out[j]`` reads
    its own.  ``out[j]`` is the real head at padded slot j, -1 for a pad:
    40 heads in 8 groups over 16 pad each group of 5 to 6 (48 = 16 x 3),
    56 in 8 groups of 7 to 8 (64 = 16 x 4); MLA's heads, each with its own
    K and V, are one group: 3 over 4 pad to 4."""
    g = heads // groups
    gp = g
    while (groups * gp) % m:
        gp += 1
    return [(j // gp) * g + j % gp if j % gp < g else -1
            for j in range(groups * gp)]


def _model_dim(x: torch.Tensor) -> int | None:
    """The index of the mesh dim named ``model`` of a DTensor, where it
    has more than one device; None otherwise."""
    if not isinstance(x, DTensor):
        return None
    names = list(x.device_mesh.mesh_dim_names or ())
    if "model" not in names:
        return None
    i = names.index("model")
    return i if x.device_mesh.size(i) > 1 else None


def _real_columns(src: tuple[int, ...], head_dim: int, hl: int,
                  t: int) -> list[tuple[int, int]]:
    """(column of device t's padded shard, real column it holds) for each
    of the shard's ``hl`` columns that is not a pad."""
    out = []
    for cp in range(t * hl, (t + 1) * hl):
        j, e = divmod(cp, head_dim)
        if src[j] >= 0:
            out.append((cp - t * hl, src[j] * head_dim + e))
    return out


@functools.lru_cache(maxsize=None)
def _relay_plan(n_cols: int, head_dim: int, src: tuple[int, ...], m: int,
                r: int):
    """Device r's part of laying the columns of (heads x head_dim) out as
    the padded heads ``src`` (``head_pad``) split evenly over m devices,
    from an even split of the real columns.  Returns (send index, send
    sizes, receive positions, receive sizes, gather index): device r
    sends the columns ``send index`` of its shard, ``send sizes[t]`` of
    them to device t in t's order, and receives ``receive sizes[s]`` from
    device s, which land at ``receive positions`` of its padded shard;
    ``gather index`` builds the padded shard from what it received
    followed by one zero column."""
    n = n_cols // m                           # real columns a device
    hl = len(src) // m * head_dim             # padded columns a device
    mine = _real_columns(src, head_dim, hl, r)
    recv_pos, recv_sizes = [], []
    for s in range(m):
        got = [p for p, c in mine if c // n == s]
        recv_pos += got
        recv_sizes.append(len(got))
    gather = [len(recv_pos)] * hl
    for k, p in enumerate(recv_pos):
        gather[p] = k
    send_idx, send_sizes = [], []
    for t in range(m):
        sent = [c - r * n for _, c in _real_columns(src, head_dim, hl, t)
                if c // n == r]
        send_idx += sent
        send_sizes.append(len(sent))
    return (tuple(send_idx), tuple(send_sizes), tuple(recv_pos),
            tuple(recv_sizes), tuple(gather))


def _index(seq, device) -> torch.Tensor:
    """``seq`` as an index tensor on ``device``."""
    return torch.tensor(seq, dtype=torch.long, device=device)


def _all_to_all_cols(x: torch.Tensor, out_sizes, in_sizes, mesh,
                     dim: int) -> torch.Tensor:
    """An all-to-all over mesh dim ``dim`` of x's last-dim columns:
    ``in_sizes[t]`` columns to device t, ``out_sizes[s]`` from device s,
    in device order."""
    import torch.distributed._functional_collectives as funcol
    buf = x.movedim(-1, 0).contiguous()
    got = funcol.all_to_all_single(buf, list(out_sizes), list(in_sizes),
                                   (mesh, dim))
    return got.movedim(0, -1)


def _pad_spec(x: torch.Tensor, heads: int, head_dim: int, groups: int):
    """How :func:`split_heads` pads ``x`` (..., heads x head_dim): None
    where no padding is needed or possible (a plain tensor, no ``model``
    dim of more than one device, heads it divides, a last dim not split
    evenly over ``model`` alone, a partial sum); else (model dim index,
    its size, ``head_pad``)."""
    md = _model_dim(x)
    if md is None or x.shape[-1] != heads * head_dim:
        return None
    m = x.device_mesh.size(md)
    pl, last = x.placements, x.ndim - 1
    if heads % m == 0 or heads * head_dim % m \
            or any(p.is_partial() for p in pl) \
            or not (isinstance(pl[md], Shard) and pl[md].dim == last) \
            or any(isinstance(p, Shard) and p.dim == last
                   for i, p in enumerate(pl) if i != md):
        return None
    return md, m, tuple(head_pad(heads, groups, m))


def _wrap(local, mesh, pl, shape) -> DTensor:
    """``local`` as a DTensor of global ``shape`` (contiguous)."""
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, mesh, pl, run_check=False,
                              shape=torch.Size(shape), stride=stride)


def _to_padded(xl: torch.Tensor, plan, mesh, md: int) -> torch.Tensor:
    """A device's padded shard from its shard of the real columns, by the
    all-to-all of ``plan``."""
    got = _all_to_all_cols(xl.index_select(-1, _index(plan[0], xl.device)),
                           plan[3], plan[1], mesh, md)
    got = torch.cat([got, got.new_zeros(got.shape[:-1] + (1,))], -1)
    return got.index_select(-1, _index(plan[4], xl.device))


def _to_real(yl: torch.Tensor, plan, mesh, md: int) -> torch.Tensor:
    """A device's shard of the real columns from its padded shard: the
    reverse all-to-all of ``plan``, the pads dropped."""
    back = _all_to_all_cols(yl.index_select(-1, _index(plan[2], yl.device)),
                            plan[1], plan[3], mesh, md)
    inverse = [0] * len(plan[0])
    for i, c in enumerate(plan[0]):
        inverse[c] = i
    return back.index_select(-1, _index(inverse, yl.device))


def _local(g: DTensor, want: list) -> torch.Tensor:
    """A gradient's local tensor, laid out as ``want`` first."""
    if list(g.placements) != want:
        g = g.redistribute(g.device_mesh, want)
    return g.to_local()


class _PadHeads(torch.autograd.Function):
    """x (..., heads x head_dim), its columns split evenly over ``model``,
    as the columns of the padded heads (``head_pad``) split evenly over
    ``model``, the pads zero, by an all-to-all over ``model`` (the count
    sees it); its backward takes the real columns' gradients back by the
    reverse all-to-all.  ``calls`` counts the forwards."""

    calls = 0

    @staticmethod
    def forward(ctx, x, head_dim, md, m, src):
        _PadHeads.calls += 1
        mesh = x.device_mesh
        plan = _relay_plan(x.shape[-1], head_dim, src, m,
                           mesh.get_coordinate()[md])
        pl = list(x.placements)
        ctx.args = (mesh, md, plan, pl, x.shape)
        return _wrap(_to_padded(x.to_local(), plan, mesh, md), mesh, pl,
                     (*x.shape[:-1], len(src) * head_dim))

    @staticmethod
    def backward(ctx, g):
        mesh, md, plan, pl, shape = ctx.args
        return (_wrap(_to_real(_local(g, pl), plan, mesh, md), mesh, pl,
                      tuple(shape)),
                None, None, None, None)


class _UnpadHeads(torch.autograd.Function):
    """The inverse of :class:`_PadHeads`: padded heads split evenly over
    ``model`` as the real heads' columns split evenly over ``model`` (the
    row split of an output projection), the pads dropped, by the reverse
    all-to-all; its backward is :class:`_PadHeads`' forward (the pads'
    gradients zero)."""

    @staticmethod
    def forward(ctx, y, n_cols, head_dim, md, m, src):
        mesh = y.device_mesh
        plan = _relay_plan(n_cols, head_dim, src, m,
                           mesh.get_coordinate()[md])
        want = list(y.placements)
        want[md] = Shard(y.ndim - 1)
        ctx.args = (mesh, md, plan, want, y.shape)
        return _wrap(_to_real(_local(y, want), plan, mesh, md), mesh, want,
                     (*y.shape[:-1], n_cols))

    @staticmethod
    def backward(ctx, g):
        mesh, md, plan, want, shape = ctx.args
        return (_wrap(_to_padded(_local(g, want), plan, mesh, md),
                      mesh, want, tuple(shape)),
                None, None, None, None, None)


def split_heads(x: torch.Tensor, heads: int, head_dim: int,
                groups: int = 1) -> torch.Tensor:
    """x (..., heads x head_dim) as (..., heads, head_dim).  Under a mesh
    whose ``model`` dim does not divide the heads, with x's columns split
    evenly over ``model``, as (..., Hp, head_dim) of padded heads
    (``head_pad``; ``groups``: the KV heads they read) split evenly over
    ``model`` (:class:`_PadHeads`).  DTensor has no uneven split:
    :func:`reshape` would gather the heads whole and every ``model``
    device would repeat their work, where XLA pads an uneven split as
    this does.  An x laid out otherwise (a replicated projection) takes
    :func:`reshape` and stays replicated."""
    spec = _pad_spec(x, heads, head_dim, groups)
    if spec is not None:
        x = _PadHeads.apply(x, head_dim, *spec)
    return reshape(x, *x.shape[:-1], x.shape[-1] // head_dim, head_dim)


def merge_heads(y: torch.Tensor, heads: int, groups: int = 1
                ) -> torch.Tensor:
    """y (..., heads or Hp, head_dim) as (..., heads x head_dim): the
    inverse of :func:`split_heads` (:class:`_UnpadHeads`)."""
    hd = y.shape[-1]
    y = reshape(y, *y.shape[:-2], y.shape[-2] * hd)
    if y.shape[-1] == heads * hd:
        return y
    md = _model_dim(y)
    m = y.device_mesh.size(md)
    return _UnpadHeads.apply(y, heads * hd, hd, md, m,
                             tuple(head_pad(heads, groups, m)))


def row_pad(rows: int, d: int) -> int:
    """The rows a microbatch of ``rows`` rows takes split evenly over
    ``d`` data devices: the least multiple of d that is >= rows, its last
    rows pads (XLA's padding of an uneven split): 8 rows over 16 take 16,
    one a device; 3 over 2 take 4."""
    return -(-rows // d) * d


@functools.lru_cache(maxsize=None)
def _row_plan(b: int, accum: int, d: int, k: int):
    """Device k's part of laying a batch of b rows, split evenly over d
    devices (n = b / d a device, in order), out as ``accum`` microbatches
    of r = b / accum rows, each padded to ``row_pad(r, d)`` and split
    evenly (q rows a device, the pads last).  Returns (send index, send
    sizes, receive sizes, gather index): device k sends the rows ``send
    index`` of its shard, ``send sizes[t]`` of them to device t, in t's
    order, and receives ``receive sizes[s]`` from device s; ``gather
    index`` builds its ``accum`` x q rows, microbatch by microbatch, from
    what it received followed by one pad row."""
    n, r = b // d, b // accum
    q = row_pad(r, d) // d

    def held(t):            # the rows device t holds, -1 a pad
        return [i * r + j if j < r else -1
                for i in range(accum) for j in range(t * q, (t + 1) * q)]

    mine = held(k)
    recv, recv_sizes = [], []
    for src in range(d):
        got = sorted(g for g in mine if g >= 0 and g // n == src)
        recv += got
        recv_sizes.append(len(got))
    at = {g: i for i, g in enumerate(recv)}
    gather = [at[g] if g >= 0 else len(recv) for g in mine]
    send_idx, send_sizes = [], []
    for t in range(d):
        sent = sorted(g - k * n for g in held(t) if g >= 0 and g // n == k)
        send_idx += sent
        send_sizes.append(len(sent))
    return (tuple(send_idx), tuple(send_sizes), tuple(recv_sizes),
            tuple(gather))


def _row_split(x: DTensor) -> tuple[list[int], int, int]:
    """The mesh dims that split a DTensor's rows (dim 0), the devices
    they make, and this device's index among them (the first mesh dim
    major, as ``Shard`` orders a dim split over several)."""
    mesh = x.device_mesh
    split = [i for i, p in enumerate(x.placements) if p == Shard(0)]
    coord = mesh.get_coordinate()
    d, k = 1, 0
    for i in split:
        d *= mesh.size(i)
        k = k * mesh.size(i) + coord[i]
    return split, d, k


def split_rows(x: torch.Tensor, accum: int, fill: float = 0
               ) -> list[torch.Tensor]:
    """``x``'s ``accum`` microbatches (``accum`` divides its B rows),
    microbatch i its rows [i r, (i + 1) r), r = B / accum: a plain
    tensor's chunks.  Of a
    DTensor whose dim 0 the data devices split (d of them), each
    microbatch as a DTensor of ``row_pad(r, d)`` rows split evenly over
    them, its pad rows (``fill``) last, re-laid out from the batch's even
    split by one all-to-all (the count sees it), as XLA re-lays out the
    reference's scanned microbatches; every device then runs its own
    rows, where DTensor's ``chunk`` would gather the batch and leave each
    microbatch whole on every device.  Rows split over more than one mesh
    dim are gathered first and split locally.  A DTensor whose dim 0 no
    mesh dim splits is chunked as it is."""
    b = x.shape[0]
    if not isinstance(x, DTensor):
        return list(x.chunk(accum))
    mesh, pl = x.device_mesh, list(x.placements)
    split, d, k = _row_split(x)
    if d == 1:
        return list(x.chunk(accum))
    r = b // accum
    q = row_pad(r, d) // d
    shape = (row_pad(r, d), *x.shape[1:])
    if len(split) == 1:
        import torch.distributed._functional_collectives as funcol
        send, send_sizes, recv_sizes, gather = _row_plan(b, accum, d, k)
        xl = x.to_local()
        got = funcol.all_to_all_single(
            xl.index_select(0, _index(send, xl.device)).contiguous(),
            list(recv_sizes), list(send_sizes), (mesh, split[0]))
    else:
        whole = [Replicate() if i in split else p for i, p in enumerate(pl)]
        got = x.redistribute(mesh, whole).to_local()
        gather = tuple(i * r + j if j < r else b
                       for i in range(accum)
                       for j in range(k * q, (k + 1) * q))
    got = torch.cat([got, got.new_full((1, *got.shape[1:]), fill)])
    local = got.index_select(0, _index(gather, got.device))
    return [_wrap(local[i * q:(i + 1) * q], mesh, pl, shape)
            for i in range(accum)]


# (mask, real rows) of the microbatch whose rows are padded, while its
# step runs (``real_rows``)
_REAL_ROWS: list = [None]


@contextlib.contextmanager
def real_rows(mb: torch.Tensor, rows: int) -> Iterator[None]:
    """While a padded microbatch's loss and gradients run: ``mb`` (any of
    its DTensors from :func:`split_rows`) holds ``rows`` real rows, and
    :func:`row_weights` gives their mask.  Nothing where ``mb`` has no
    pad rows."""
    if mb.shape[0] == rows:
        yield
        return
    _, _, k = _row_split(mb)
    q = mb.to_local().shape[0]
    mask = (torch.arange(k * q, (k + 1) * q, device=mb.device) < rows
            ).to(torch.float32)
    prev = _REAL_ROWS[0]
    rows_pl = [Shard(0) if p == Shard(0) else Replicate()
               for p in mb.placements]
    _REAL_ROWS[0] = (_wrap(mask, mb.device_mesh, rows_pl, (mb.shape[0],)),
                     rows)
    try:
        yield
    finally:
        _REAL_ROWS[0] = prev


def row_weights() -> tuple[torch.Tensor, int] | None:
    """(a 1.0 / 0.0 mask of the rows that are real, laid out as the
    rows; how many are real) while a padded microbatch runs
    (:func:`real_rows`); None otherwise.  A reduction over rows that no
    label masks (the MoE load-balance loss) weighs its rows by it, so
    that the pads add nothing."""
    return _REAL_ROWS[0]


def like_layout(x: torch.Tensor, dims: dict[int, int]
                ) -> list[Placement] | None:
    """``x``'s placements carried over to another tensor whose dim
    ``dims[d]`` stands for ``x``'s dim d (a dim ``dims`` does not map is
    replicated); None for a plain tensor."""
    if not isinstance(x, DTensor):
        return None
    return [Shard(dims[p.dim]) if isinstance(p, Shard) and p.dim in dims
            else Replicate() for p in x.placements]


def on_local(fn, args: Sequence, layouts: Sequence, out_layouts: Any):
    """``fn`` on local shards.  Each DTensor of ``args`` is redistributed
    to its entry of ``layouts`` (None: as it is) and passed as its local
    tensor; a plain tensor with a layout joins as a replicated DTensor
    first (the model's own ``arange``s and zeros), one without is passed
    as it is; anything else is passed as it is.  ``fn``'s tensor result
    (or each of a tuple) is wrapped as a DTensor with its entry of
    ``out_layouts`` (a list of placements, or a tuple of them), its shard
    the same on every device of a dim it shards.  With no DTensor among
    ``args`` this is ``fn(*args)``.  Local tensors alias their DTensors
    when no redistribute was needed, so ``fn`` may write into them in
    place (a decode cache).

    torch's ``local_map`` does the rest of this but not the plain
    tensors: it passes a plain tensor whole whatever its placements say,
    where the model's per-lane positions and slots (plain ``arange``s
    and a plain ``cache["pos"]``) must reach ``fn`` as the device's rows
    of the batch split."""
    mesh = next((a.device_mesh for a in args if isinstance(a, DTensor)),
                None)
    if mesh is None:
        return fn(*args)
    local = []
    for a, lay in zip(args, layouts):
        if isinstance(a, torch.Tensor) and not isinstance(a, DTensor) \
                and lay is not None:
            a = DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        if isinstance(a, DTensor):
            if lay is not None and list(a.placements) != list(lay):
                a = a.redistribute(mesh, lay)
            a = a.to_local()
        local.append(a)
    out = fn(*local)
    if out is None:
        return None
    if isinstance(out, tuple):
        return tuple(DTensor.from_local(o, mesh, lay, run_check=False)
                     for o, lay in zip(out, out_layouts))
    return DTensor.from_local(out, mesh, out_layouts, run_check=False)


def batch_axes() -> tuple[str, ...] | None:
    """Axes the global batch shards over: ("pod", "data") where both
    exist."""
    axes = current_axis_names()
    got = tuple(a for a in ("pod", "data") if a in axes)
    return got if got else None


def shard_devices(n: int, home: torch.device) -> list[torch.device] | None:
    """Pick ``n`` distinct devices to scatter work shards onto.

    When ``home`` (the executor's device) is a CUDA card and the machine
    has at least ``n`` cards, the shards go to ``cuda:0 .. cuda:n-1``.
    Otherwise — one card, or the CPU — this returns None: the caller's cue
    to take the sequential fallback, where the shards dispatch in turn on
    ``home`` with identical numerics (the reference's off-mesh fallback).
    """
    if n <= 1 or home.type != "cuda" or torch.cuda.device_count() < n:
        return None
    return [torch.device("cuda", i) for i in range(n)]
