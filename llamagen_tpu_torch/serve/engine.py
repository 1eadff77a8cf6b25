"""Slot-based continuous-batching serving engine for c2i generation, in
PyTorch.

Counterpart of `llamagen_tpu/serve/engine.py` (its c2i half, one device).
Every step decodes ALL slots over a dense preallocated KV cache: P request
slots, each a [cond ‖ null] pair of cache rows (row i and row P + i), with a
position per slot; requests are admitted into free slots at chunk
boundaries. A c2i slot's class token runs as an ordinary step at position 0
(the embedding select of `build_step_embeddings`), so admission costs no
prefill. Sampling parameters are per-slot tensors written at admission, so
requests with different cfg scales, temperatures and filters share a step.

The JAX chunk is one compiled `fori_loop`; here it is a Python loop of
`n_steps <= chunk` steps whose state is updated in place or by
`torch.where`, with no device-to-host read inside a chunk: the host keeps
its own mirror of each slot's progress (positions, tokens left, filters),
so it sizes each chunk, checks the cache bounds and decides whether the
top-k / top-p sort runs without reading the device. The decode-attention
kernel (`ops/attention.py`) takes the `[2P]` positions in every layer; with
W8A16 weights the layer matmuls run on the int8 kernel at 2P rows.

Not ported yet: t2i serving (caption admission, `submit_caption`,
`generate_t2i`, `make_admit_batch`, `make_admit_pair`,
`scatter_pair_local`, `make_scatter_pair`; ROADMAP.md Queue 1 item 4; a
t2i model raises `NotImplementedError`) and tensor-parallel serving (the
`tp` argument; ROADMAP.md Queue 1 item 9).
"""

from __future__ import annotations

import queue
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from llamagen_tpu_torch.config import GPTConfig, find_multiple
from llamagen_tpu_torch.models import gpt
from llamagen_tpu_torch.ops import sampling

_T2I = "t2i serving is not ported yet (ROADMAP.md Queue 1 item 4)"


class SlotSampling(NamedTuple):
    """Per-slot sampling parameters, [P] tensors on the engine's device,
    written at admission."""
    cfg_scale: torch.Tensor    # [P] f32 (1.0 = no guidance)
    temperature: torch.Tensor  # [P] f32 (<= 0 = greedy argmax)
    top_k: torch.Tensor        # [P] i32 (0 = off)
    top_p: torch.Tensor        # [P] f32 (>= 1 = off)
    presence: torch.Tensor     # [P] f32
    frequency: torch.Tensor    # [P] f32
    repetition: torch.Tensor   # [P] f32 (1.0 = off)


@dataclass
class EngineState:
    """The engine's device state. The cache holds 2P rows (cond rows
    first); an int8 cache carries its `kv_scale` and exact `tail` (the JAX
    engine's `recent` windows) in place."""
    cache: gpt.KVCache
    pos: torch.Tensor          # [P] int32 next write position (pair-shared)
    active: torch.Tensor       # [P] bool
    cur_token: torch.Tensor    # [P] int64 last sampled token
    labels: torch.Tensor       # [P] int64 class of the running request
    n_generated: torch.Tensor  # [P] int32 tokens produced so far
    tokens_out: torch.Tensor   # [P, max_new] int64 output buffer
    generator: torch.Generator
    sp_slots: SlotSampling
    output_counts: Optional[torch.Tensor] = None  # [P, V] int32 penalties


@dataclass
class SamplingParams:
    """Per-engine (or per-request) sampling configuration; penalties follow
    the vLLM semantics of `ops.sampling.apply_penalties`."""
    cfg_scale: float = 2.0
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    repetition_penalty: float = 1.0

    @property
    def uses_penalties(self) -> bool:
        return (self.presence_penalty != 0.0 or self.frequency_penalty != 0.0
                or self.repetition_penalty != 1.0)

    @property
    def filters_off(self) -> bool:
        return self.top_k <= 0 and self.top_p >= 1.0

    def row(self) -> List[float]:
        """The values in `SlotSampling` order."""
        return [self.cfg_scale, self.temperature, self.top_k, self.top_p,
                self.presence_penalty, self.frequency_penalty,
                self.repetition_penalty]


def slot_sampling_full(sp: SamplingParams, num_pairs: int,
                       device=None) -> SlotSampling:
    """One SamplingParams broadcast to every slot."""
    return SlotSampling(*(
        torch.full((num_pairs,), v, device=device,
                   dtype=torch.int32 if f == "top_k" else torch.float32)
        for f, v in zip(SlotSampling._fields, sp.row())))


def init_engine_state(cfg: GPTConfig, num_pairs: int, max_new_tokens: int,
                      generator: torch.Generator, device,
                      cache_dtype: torch.dtype = torch.bfloat16,
                      compute_dtype: torch.dtype = torch.bfloat16,
                      track_counts: bool = False,
                      sp: Optional[SamplingParams] = None) -> EngineState:
    """Idle slots over a cache of find_multiple(cls + max_new, 128) rows:
    a finished slot keeps stepping at pos max_new, so every slot's position
    stays inside it. An int8 cache starts empty (zero rows, scales 1.0,
    zero tail), as the JAX engine's does."""
    smax = find_multiple(cfg.cls_token_num + max_new_tokens, 128)
    zeros = lambda dt: torch.zeros(num_pairs, dtype=dt, device=device)
    return EngineState(
        cache=gpt.init_cache(cfg, 2 * num_pairs, smax, cache_dtype, device,
                             compute_dtype=compute_dtype),
        pos=zeros(torch.int32), active=zeros(torch.bool),
        cur_token=zeros(torch.long), labels=zeros(torch.long),
        n_generated=zeros(torch.int32),
        tokens_out=torch.zeros(num_pairs, max_new_tokens, dtype=torch.long,
                               device=device),
        generator=generator,
        sp_slots=slot_sampling_full(sp or SamplingParams(), num_pairs,
                                    device),
        output_counts=(torch.zeros(num_pairs, cfg.vocab_size,
                                   dtype=torch.int32, device=device)
                       if track_counts else None))


def build_step_embeddings(model: gpt.Transformer, state: EngineState,
                          compute_dtype: torch.dtype) -> torch.Tensor:
    """Per-slot input embeddings of one step, [2P, D], the cond half over
    the uncond half: a slot at its first step (active, pos 0) reads its
    class / null-class embedding, every other slot its last token's."""
    cfg = model.cfg
    tok_emb = model.tok_embeddings.weight[state.cur_token]
    table = model.cls_embedding.embedding_table.weight
    first = (state.active & (state.pos == 0))[:, None]
    emb_cond = torch.where(first, table[state.labels], tok_emb)
    emb_uncond = torch.where(first, table[cfg.num_classes], tok_emb)
    return torch.cat([emb_cond, emb_uncond]).to(compute_dtype)


def sample_and_advance(state: EngineState, logits: torch.Tensor,
                       max_new_tokens: int, filters_off: bool = False) -> None:
    """The tail of one step, in place: CFG mix with per-slot scales,
    penalties, sampling, then the bookkeeping (write the token of every
    active unfinished slot, advance pos and n_generated, retire finished
    slots). `filters_off`: the host knows no slot asks for top-k / top-p."""
    ss = state.sp_slots
    mixed = sampling.cfg_mix(logits, ss.cfg_scale)
    counts = state.output_counts
    if counts is not None:
        mixed = sampling.apply_penalties(
            mixed, counts, presence=ss.presence, frequency=ss.frequency,
            repetition=ss.repetition)
    nxt = sampling.sample_per_slot(mixed, ss.temperature, ss.top_k,
                                   ss.top_p, state.generator, filters_off)
    going = state.active & (state.n_generated < max_new_tokens)
    cols = torch.arange(max_new_tokens, device=nxt.device)
    write = going[:, None] & (cols[None, :] == state.n_generated[:, None])
    state.tokens_out = torch.where(write, nxt[:, None], state.tokens_out)
    state.n_generated = state.n_generated + going.to(torch.int32)
    state.cur_token = torch.where(going, nxt, state.cur_token)
    state.pos = state.pos + state.active.to(torch.int32)
    state.active = state.active & (state.n_generated < max_new_tokens)
    if counts is not None:
        sampling.update_output_counts(counts, nxt, going)


def apply_admission(state: EngineState, admit_mask: torch.Tensor,
                    admit_labels: torch.Tensor,
                    admit_sp: SlotSampling) -> None:
    """Reset the admitted slots' bookkeeping and write their sampling
    parameters, in place. Their cache rows need no reset: a slot reads
    only rows it has written since its admission."""
    state.pos = torch.where(admit_mask, 0, state.pos)
    state.active = state.active | admit_mask
    state.labels = torch.where(admit_mask, admit_labels, state.labels)
    state.n_generated = torch.where(admit_mask, 0, state.n_generated)
    state.sp_slots = SlotSampling(*(
        torch.where(admit_mask, a.to(s.dtype), s)
        for a, s in zip(admit_sp, state.sp_slots)))
    if state.output_counts is not None:
        state.output_counts = torch.where(admit_mask[:, None], 0,
                                          state.output_counts)


def make_engine_step(model: gpt.Transformer, max_new_tokens: int,
                     chunk: int = 64,
                     compute_dtype: torch.dtype = torch.bfloat16):
    """The chunked engine step: engine_step(state, admit_mask [P] bool,
    admit_labels [P], admit_sp SlotSampling, n_steps, filters_off) admits
    (when `admit_mask` is not None) and runs n_steps <= chunk decode steps
    in place (JAX clamps n_steps to the chunk; here a larger one raises,
    since the caller's mirror of the slots would go wrong). No step reads
    the device from the host."""

    @torch.no_grad()
    def engine_step(state: EngineState, admit_mask: Optional[torch.Tensor],
                    admit_labels: Optional[torch.Tensor],
                    admit_sp: Optional[SlotSampling], n_steps: int,
                    filters_off: bool = False) -> EngineState:
        if n_steps > chunk:
            raise ValueError(f"{n_steps} steps, more than the chunk {chunk}")
        if admit_mask is not None:
            apply_admission(state, admit_mask, admit_labels, admit_sp)
        for _ in range(n_steps):
            emb = build_step_embeddings(model, state, compute_dtype)
            pos2 = torch.cat([state.pos, state.pos])
            logits = gpt.decode_step_slots(model, emb, pos2, state.cache,
                                           compute_dtype)
            sample_and_advance(state, logits, max_new_tokens, filters_off)
        return state

    return engine_step


@dataclass
class Request:
    label: int
    request_id: int
    sp: Optional[SamplingParams] = None      # per-request override
    result: Optional[np.ndarray] = None
    submitted_at: float = field(default_factory=time.time)
    admitted_at: Optional[float] = None      # host time of admission
    first_token_at: Optional[float] = None   # TTFT (interpolated, _harvest)
    finished_at: Optional[float] = None


class ServeEngine:
    """Host-side request loop over the chunked step: `submit` + `run_until_
    idle` for online serving, `generate` for an offline batch. The model's
    device is the engine's device."""

    def __init__(self, model: gpt.Transformer, *, num_pairs: int = 16,
                 max_new_tokens: int = 576,
                 sampling_params: Optional[SamplingParams] = None,
                 chunk: int = 64, seed: int = 0,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 cache_dtype: Optional[torch.dtype] = None,
                 track_penalties: bool = False):
        cfg = model.cfg
        if cfg.model_type != "c2i":
            raise NotImplementedError(_T2I)
        if not 0 < max_new_tokens <= cfg.block_size:
            raise ValueError(f"max_new_tokens {max_new_tokens} outside "
                             f"(0, block_size {cfg.block_size}]")
        self.cfg = cfg
        self.device = model.freqs_cis.device
        self.num_pairs = num_pairs
        self.max_new_tokens = max_new_tokens
        self.sp = sampling_params or SamplingParams()
        self.chunk = chunk
        self.step_fn = make_engine_step(model, max_new_tokens, chunk,
                                        compute_dtype)
        self.state = init_engine_state(
            cfg, num_pairs, max_new_tokens,
            torch.Generator(device=self.device).manual_seed(seed),
            self.device, cache_dtype=cache_dtype or compute_dtype,
            compute_dtype=compute_dtype,
            track_counts=self.sp.uses_penalties or track_penalties,
            sp=self.sp)
        self.cache_rows = self.state.cache.kv[0].shape[1]
        self.slot_request: List[Optional[Request]] = [None] * num_pairs
        # host mirror of each slot's progress (it advances deterministically)
        # sizes the chunks, checks the cache bounds and gates the filters
        # without reading the device
        self._slot_remaining = np.zeros((num_pairs,), np.int64)
        self._slot_pos = np.zeros((num_pairs,), np.int64)
        self._slot_filters_off = np.ones((num_pairs,), bool)
        self.steps_run = 0  # decode steps since construction (host count)
        self.pending: "queue.Queue[Request]" = queue.Queue()
        self._next_id = 0
        self.reset_stats()

    def submit(self, label: int,
               sp: Optional[SamplingParams] = None) -> Request:
        """A c2i request; `sp` overrides the engine's sampling parameters
        for this request only. Per-request penalties need the engine built
        with track_penalties=True (the counts buffer)."""
        sp = sp or self.sp
        if sp.uses_penalties and self.state.output_counts is None:
            raise ValueError("per-request penalties need ServeEngine("
                             "track_penalties=True)")
        req = Request(label=int(label), request_id=self._next_id, sp=sp)
        self._next_id += 1
        self.pending.put(req)
        return req

    def _admission(self, admitted: Dict[int, Request]):
        """(mask, labels, SlotSampling) on the device from one host copy
        (pinned, asynchronous): no synchronising transfer."""
        packed = np.zeros((2 + len(SlotSampling._fields), self.num_pairs),
                          np.float32)
        for i, req in admitted.items():
            packed[:, i] = [1.0, req.label] + req.sp.row()
        host = torch.from_numpy(packed)
        if self.device.type == "cuda":
            host = host.pin_memory()
        dev = host.to(self.device, non_blocking=True)
        return dev[0] > 0, dev[1].long(), SlotSampling(*dev[2:])

    def _admit_and_step(self) -> None:
        admitted: Dict[int, Request] = {}
        for i in range(self.num_pairs):
            if self.slot_request[i] is None and not self.pending.empty():
                req = self.pending.get()
                self.slot_request[i] = admitted[i] = req
                self._slot_remaining[i] = self.max_new_tokens
                self._slot_pos[i] = 0
                self._slot_filters_off[i] = req.sp.filters_off
        # exact-step chunking: run until the next slot finishes (or the
        # chunk cap), so no finished slot idles through a fixed chunk
        busy = self._slot_remaining > 0
        n_steps = int(min(self._slot_remaining[busy].min(), self.chunk)) \
            if busy.any() else self.chunk
        # the highest cache row each slot writes in this chunk: busy slots
        # advance n_steps, idle ones step at their fixed position
        last = self._slot_pos + np.where(busy, n_steps - 1, 0)
        if last.max() >= self.cache_rows:  # K1 would write past the cache
            raise RuntimeError(f"slot rows {last} outside the cache of "
                               f"{self.cache_rows}")
        filters_off = bool(all(self._slot_filters_off[i]
                               for i in range(self.num_pairs)
                               if self.slot_request[i] is not None))
        now = time.time()
        for req in admitted.values():
            req.admitted_at = now  # _harvest interpolates the first token
        adm = self._admission(admitted) if admitted else (None, None, None)
        self.state = self.step_fn(self.state, *adm, n_steps, filters_off)
        self.steps_run += n_steps
        self._slot_pos[busy] += n_steps
        self._slot_remaining[busy] -= n_steps

    def _harvest(self) -> None:
        done = [i for i in range(self.num_pairs)
                if self.slot_request[i] is not None
                and self._slot_remaining[i] == 0]
        if not done:
            return
        tokens = self.state.tokens_out.cpu().numpy()  # one read a harvest
        for i in done:
            req = self.slot_request[i]
            req.result = tokens[i].copy()
            req.finished_at = time.time()
            self._latencies.append(req.finished_at - req.submitted_at)
            # the only wall-clock observations are the admission and this
            # read: the first token (step 1 of the admission chunk) is
            # interpolated at the measured per-step rate
            per_step = (req.finished_at - req.admitted_at) \
                / max(self.max_new_tokens, 1)
            req.first_token_at = req.admitted_at + per_step
            self._ttfts.append(req.first_token_at - req.submitted_at)
            self._completed += 1
            self.slot_request[i] = None

    def run_until_idle(self) -> None:
        """Process everything in the queue to completion."""
        while (not self.pending.empty()
               or any(r is not None for r in self.slot_request)):
            self._admit_and_step()
            self._harvest()

    def generate(self, labels) -> np.ndarray:
        """Offline batch: labels [N] -> token grids [N, max_new_tokens], in
        submission order."""
        reqs = [self.submit(l) for l in labels]
        self.run_until_idle()
        return np.stack([r.result for r in reqs])

    def reset_stats(self) -> None:
        """Zero the stats() gauges (latency and TTFT samples, completions,
        the throughput clock), e.g. after a warm-up."""
        self._latencies: List[float] = []
        self._ttfts: List[float] = []
        self._completed = 0
        self._started = time.time()

    def stats(self) -> Dict[str, Any]:
        """The JAX engine's gauges: running / waiting counts, slot
        occupancy, completions, throughput, e2e latency, TTFT and TPOT
        (time per output token after the first). Read from the host
        mirror: no device read."""
        active = self._slot_remaining > 0
        lat = np.asarray(self._latencies) if self._latencies else None
        ttft = np.asarray(self._ttfts) if self._ttfts else None
        elapsed = max(time.time() - self._started, 1e-9)
        tpot = None
        if lat is not None and ttft is not None and len(lat) == len(ttft) \
                and self.max_new_tokens > 1:
            tpot = (lat - ttft) / (self.max_new_tokens - 1)

        def pct(x, q):
            return float(np.percentile(x, q)) if x is not None else None

        def mean(x):
            return float(x.mean()) if x is not None else None

        return {
            "running": int(active.sum()),
            "waiting": self.pending.qsize(),
            "slots": self.num_pairs,
            "slot_occupancy": float(active.mean()),
            "completed": self._completed,
            "throughput_img_per_s": self._completed / elapsed,
            "e2e_latency_mean_s": mean(lat),
            "e2e_latency_p50_s": pct(lat, 50),
            "e2e_latency_p95_s": pct(lat, 95),
            "e2e_latency_p99_s": pct(lat, 99),
            "ttft_mean_s": mean(ttft),
            "ttft_p50_s": pct(ttft, 50),
            "ttft_p95_s": pct(ttft, 95),
            "tpot_mean_s": mean(tpot),
            "tpot_p50_s": pct(tpot, 50),
            "tpot_p95_s": pct(tpot, 95),
        }
