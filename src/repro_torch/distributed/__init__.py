"""Distributed runtime pieces of the port: straggler deadlines, the
fault-tolerant training runner (``distributed.fault``) and the device
picker of sharded offload dispatch (``distributed.sharding``).

``shard_devices(n, home)`` hands the sharded offload backend one CUDA card
per shard when the machine has ``n`` of them; on one card or on the CPU
it returns None and the shards run in turn on the executor's device."""

from repro_torch.distributed.sharding import shard_devices
from repro_torch.distributed.straggler import TrailingMedianDeadline

__all__ = ["TrailingMedianDeadline", "shard_devices"]
