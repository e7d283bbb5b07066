"""Batched serving engine: continuous batching over fixed cache slots.

  * ``submit`` queues requests (prompt token lists);
  * ``step`` admits queued requests into free slots (single-lane prefill,
    cache splice) and runs ONE batched ``decode_step`` for all slots —
    the cache carries per-lane positions, so lanes at different depths
    decode together (continuous batching);
  * finished sequences (EOS / max_new_tokens / cache full) free slots.

The engine runs on the device its parameters lie on (the CUDA card unless
the caller built them with ``device="cpu"``).  It casts the weights to the
activation dtype once, when it is built (``models.compute_params``); the
reference casts them on every call, which gives the same numbers.

Analog offload (opt-in): pass ``offload=`` a ``repro_torch.runtime``
``OffloadScheduler``, ``PlanRouter``, or bare ``OffloadExecutor`` and
attention-adjacent FFT/conv work — e.g. spectral retrieval scoring or conv
feature extraction riding along with generation — can be queued via
:meth:`ServingEngine.submit_aux`.  With a scheduler, the decode step runs
an admission *poll* instead of a forced flush: aux groups may be held open
across decode steps under the scheduler's deadline, so trickle aux traffic
accumulates occupancy across steps instead of crossing the conversion
boundary once per step.  With a plain router/executor the engine flushes
once per decode step, which already coalesces aux calls submitted by
different requests within a step into one boundary crossing (the paper's
§6 lever).  Either way the runtime's telemetry observes real serving
traffic for re-planning.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import LM
from repro_torch.models.params import compute_params

__all__ = ["Request", "ServingEngine"]


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new_tokens: int = 16
    out_tokens: list[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ServingEngine:
    def __init__(self, cfg: ModelConfig, params: Any, *, batch_slots: int = 4,
                 max_len: int = 256, eos_id: int | None = None,
                 offload: Any | None = None) -> None:
        self.cfg = cfg
        self.model = LM(cfg)
        self.params = compute_params(cfg, params)
        self.device = params["embed"].device
        self.slots = batch_slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.queue: list[Request] = []
        self.active: dict[int, Request] = {}
        self.cache = self.model.init_cache(batch_slots, max_len,
                                           device=self.device)
        self.last_token = [0] * batch_slots
        # analog-offload hook: an OffloadScheduler / PlanRouter /
        # OffloadExecutor (duck-typed on submit/flush/pending, schedulers
        # additionally on poll) or None; aux submissions batch across
        # decode steps.
        self.offload = offload

    # -- client API ----------------------------------------------------------
    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def submit_aux(self, category: str, x: torch.Tensor, **kwargs):
        """Queue attention-adjacent FFT/conv/matmul work on the offload
        runtime; returns an ``OffloadResult`` handle.  With a plain
        router/executor hook it materializes at the next decode step; with
        an ``OffloadScheduler`` hook it materializes when admission control
        releases its group (full / deadline / futile — possibly several
        decode steps later).  ``handle.get()`` always forces it.  Requires
        the engine to have been constructed with ``offload=``."""
        if self.offload is None:
            raise RuntimeError("engine built without offload= runtime")
        return self.offload.submit(category, x, **kwargs)

    @property
    def pending_aux(self) -> int:
        # the runtime's queue is the single source of truth: callers may
        # drain it directly (handle.get(), router.flush()) between steps
        return self.offload.pending if self.offload is not None else 0

    def flush_aux(self) -> list:
        """Dispatch queued aux work as batched accelerator invocations."""
        return self.offload.flush() if self.offload is not None else []

    def idle(self) -> bool:
        return not self.queue and not self.active and not self.pending_aux

    # -- internals -------------------------------------------------------------
    def _splice_slot(self, slot: int, slot_cache: dict) -> None:
        """Copy a prefilled 1-lane cache into lane ``slot`` of the batch
        cache, leaf by leaf: ``pos`` is (lanes,); a prefix/tail layer's
        leaves (k, v and slot_pos, an MLA layer's latent, or a recurrent
        layer's states) have the lane first; a stacked layer's have the layer axis first and
        the lane second.  Every leaf of the lane is overwritten, so a
        lane freed by a finished request starts the next one from that
        request's own prefill, with none of the old state left."""
        self.cache["pos"][slot] = slot_cache["pos"][0]
        for section in ("prefix", "tail"):
            for key, layer in self.cache.get(section, {}).items():
                for name, dst in layer.items():
                    dst[slot] = slot_cache[section][key][name][0]
        for key, layer in self.cache.get("stack", {}).items():
            for name, dst in layer.items():
                dst[:, slot] = slot_cache["stack"][key][name][:, 0]

    def _admit(self) -> None:
        free = [s for s in range(self.slots) if s not in self.active]
        while free and self.queue:
            slot = free.pop(0)
            req = self.queue.pop(0)
            # prompts go in at their own length: eager PyTorch has no
            # recompiles for the reference's prompt_bucket padding to bound
            toks = torch.tensor([req.prompt], dtype=torch.int64,
                                device=self.device)
            slot_cache, logits = self.model.prefill(
                self.params, {"tokens": toks}, max_len=self.max_len)
            self._splice_slot(slot, slot_cache)
            nxt = int(torch.argmax(logits[0]))
            req.out_tokens.append(nxt)
            self.last_token[slot] = nxt
            self.active[slot] = req

    def step(self) -> list[Request]:
        """Admit waiting requests, run the aux offload admission pass (a
        scheduler poll when one is driving — held groups survive the step;
        a forced flush otherwise), then one batched decode step."""
        self._admit()
        poll = getattr(self.offload, "poll", None)
        if poll is not None:
            # scheduler-driven: release only full/due/futile groups; a
            # partially filled group rides to the next decode step
            poll()
        elif self.pending_aux:
            self.flush_aux()
        if not self.active:
            return []
        tokens = torch.tensor(self.last_token, dtype=torch.int64,
                              device=self.device)[:, None]
        logits, self.cache = self.model.decode_step(self.params, self.cache,
                                                    tokens)
        next_tokens = torch.argmax(logits, dim=-1).tolist()
        pos_host = self.cache["pos"].tolist()
        finished = []
        for slot, req in list(self.active.items()):
            nxt = next_tokens[slot]
            req.out_tokens.append(nxt)
            self.last_token[slot] = nxt
            if (self.eos_id is not None and nxt == self.eos_id) \
                    or len(req.out_tokens) >= req.max_new_tokens \
                    or pos_host[slot] >= self.max_len - 1:
                req.done = True
                finished.append(req)
                del self.active[slot]
        return finished

    def run_to_completion(self, max_steps: int = 10_000) -> list[Request]:
        done: list[Request] = []
        for _ in range(max_steps):
            done.extend(self.step())
            if self.idle():
                break
        return done
