"""Public wrappers over the port's hand-written kernels.

Call sites import from here; the kernels and their build stay private.
Each wrapper runs its CUDA kernel for tensors on the card and its plain
PyTorch version for tensors on the CPU: the DFT stages
(``optical_dft``), the converter boundary (``converter_boundary``) and the
flash attention (``local_flash_attention``, with the 4-D
``gqa_flash_attention`` wrapper), which is differentiable.

``gqa_flash_attention`` also takes DTensors (a training step under a
mesh): the kernel then runs on each rank's local shards, whole heads,
and never sees a DTensor (it launches on raw pointers).
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.kernels.adc_dac import converter_boundary
from repro_torch.kernels.local_attention import local_flash_attention
from repro_torch.kernels.optical_dft import (
    dft_matrix_factors,
    dft_stage1,
    dft_stage1_batched,
    dft_stage2,
    dft_stage2_batched,
    optical_dft2_intensity,
    optical_dft2_intensity_batched,
)

__all__ = [
    "optical_dft2_intensity",
    "optical_dft2_intensity_batched",
    "dft_stage1",
    "dft_stage1_batched",
    "dft_stage2",
    "dft_stage2_batched",
    "dft_matrix_factors",
    "converter_boundary",
    "local_flash_attention",
    "gqa_flash_attention",
]


def gqa_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, window: int = 0, causal: bool = True,
                        ) -> torch.Tensor:
    """(B, Hq, L, D) grouped-query flash attention over 4-D operands.

    k is (B, Hkv, Lk, D) and v (B, Hkv, Lk, Dv) with Dv <= D (MLA); the
    result is (B, Hq, L, Dv).  Flattens (batch, heads) onto the kernel's
    leading axis; KV heads are shared across groups inside the kernel (no
    repeat).  Operands that are not contiguous are made so first.  DTensor
    operands go through :func:`_on_shards`.
    """
    if isinstance(q, DTensor):
        return _on_shards(q, k, v, window=window, causal=causal)
    b, hq, lq, d = q.shape
    _, hkv, lk, _ = k.shape
    if hq % hkv:
        raise ValueError(f"gqa_flash_attention: {hq} query heads do not "
                         f"group over {hkv} KV heads")
    dv = v.shape[-1]
    out = local_flash_attention(
        q.reshape(b * hq, lq, d).contiguous(),
        k.reshape(b * hkv, lk, d).contiguous(),
        v.reshape(b * hkv, lk, dv).contiguous(),
        window=window, causal=causal, kv_groups=hq // hkv,
    )
    return out.reshape(b, hq, lq, dv)


def _head_block(placements, mesh) -> tuple[int, int]:
    """(this rank's block index, number of blocks) of dim 1 (heads) under
    ``placements``: the mesh dims that shard it, major to minor."""
    coord = mesh.get_coordinate()
    idx, tot = 0, 1
    for i, pl in enumerate(placements):
        if pl == Shard(1):
            idx, tot = idx * mesh.size(i) + coord[i], tot * mesh.size(i)
    return idx, tot


def _on_shards(q: DTensor, k: DTensor, v: DTensor, *, window: int,
               causal: bool) -> DTensor:
    """Flash attention over DTensors (B, H, L, D), on the local shards.

    On each mesh dim q keeps a batch (dim 0) or head (dim 1) sharding that
    splits evenly and is replicated otherwise (the kernel needs whole
    sequences and whole head dims).  K and V follow q's batch sharding,
    and its head sharding where their heads split alike (Hkv divisible by
    q's head blocks, so the group index map holds on every shard);
    otherwise their heads are replicated, so that their gradients are
    partial sums over the mesh dims that split q's heads.  A rank whose
    query heads lie in one group then takes that group's KV head alone
    (the kernel shares it across them); one whose heads straddle a group
    boundary takes, per local query head, the KV head it reads.  The
    result is q's local output wrapped with q's placements; gradients
    pass through both wraps."""
    mesh = q.device_mesh
    b, hq, lq, _ = q.shape
    hkv, dv = k.shape[1], v.shape[-1]
    q_pl, bn, hn = [], 1, 1
    for i, pl in enumerate(q.placements):
        n = mesh.size(i)
        if pl == Shard(0) and b % (bn * n) == 0:
            bn *= n
        elif pl == Shard(1) and hq % (hn * n) == 0:
            hn *= n
        else:
            pl = Replicate()
        q_pl.append(pl)
    alike = hkv % hn == 0
    kv_pl = [pl if pl == Shard(0) or alike else Replicate() for pl in q_pl]
    q, k, v = (t if list(t.placements) == want
               else t.redistribute(mesh, want)
               for t, want in ((q, q_pl), (k, kv_pl), (v, kv_pl)))
    kv_grad = [Partial() if pl == Shard(1) and not alike else kp
               for pl, kp in zip(q_pl, kv_pl)]
    ql = q.to_local()
    kl, vl = (t.to_local(grad_placements=kv_grad) for t in (k, v))
    if not alike:
        qi, _ = _head_block(q_pl, mesh)
        hq_loc, grp = hq // hn, hq // hkv
        lo = qi * hq_loc
        if grp % hq_loc == 0:             # the shard lies in one group
            heads = slice(lo // grp, lo // grp + 1)
        else:
            heads = torch.arange(lo, lo + hq_loc, device=kl.device) // grp
        kl, vl = kl[:, heads], vl[:, heads]
    out = gqa_flash_attention(ql, kl, vl, window=window, causal=causal)
    return DTensor.from_local(out, mesh, q_pl, run_check=False,
                              shape=torch.Size((b, hq, lq, dv)),
                              stride=(hq * lq * dv, lq * dv, dv, 1))
