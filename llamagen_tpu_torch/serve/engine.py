"""Slot-based continuous-batching serving engine for c2i and t2i
generation, in PyTorch.

Counterpart of `llamagen_tpu/serve/engine.py` (one device). Every step
decodes ALL slots over a dense preallocated KV cache: P request slots, each
a [cond ‖ null] pair of cache rows (row i and row P + i), with a position
per slot; requests are admitted into free slots at chunk boundaries. A c2i
slot's class token runs as an ordinary step at position 0 (the embedding
select of `build_step_embeddings`), so admission costs no prefill. A t2i
slot is admitted out of band: `make_admit_batch` runs the 120-token
caption prefill of up to min(P, 8) pairs in one forward and samples their
first tokens, `scatter_pairs` installs the rows in the slots' cache rows
(an int8 cache quantises rows [0, base) as `generate` does, rows [base, T)
go to the exact tail) with the slots' left-pad counts, and every in-chunk
step is then pure decode with `prefix_pad`. Sampling parameters are
per-slot tensors written at admission, so requests with different cfg
scales, temperatures and filters share a step.

The JAX chunk is one compiled `fori_loop`; here it is a Python loop of
`n_steps <= chunk` steps whose state is updated in place (every tensor of
the state keeps its storage), so that on a CUDA device one decode step is
captured as a CUDA graph and replayed, one launch a step instead of a few
hundred (`DecodeGraphs`; a TP shard runs eagerly). No device-to-host read
happens inside a chunk: the host keeps
its own mirror of each slot's progress (positions, tokens left, filters),
so it sizes each chunk, checks the cache bounds and decides whether the
top-k / top-p sort runs without reading the device. The decode-attention
kernel (`ops/attention.py`) takes the `[2P]` positions in every layer; with
W8A16 weights the layer matmuls run on the int8 kernel at 2P rows (and, at
a t2i admission, at 2A * 120 rows).

Tensor-parallel serving (`tp` > 1, JAX's `serve/tp_engine.py`): the
model is a rank's TP shard (`parallel/tp_decode.py::shard_tp_params`),
which carries its heads and its process group, so this engine runs it
unchanged: each rank's cache holds its own heads (`[2P, S, 2 * F_kv /
tp]`), the step runs the local heads through K1 with two all-reduces per
layer and one gather of the logits, and a t2i admission prefills its
pairs batched, as on one card (JAX admits one pair per prefill under TP,
for its TPU cache layout, which the port does not have). Every rank runs
this same host loop (SPMD). The contract: every rank submits the same
requests in the same order (and calls `run_until_idle` / `generate`
alike), so every rank makes the same admissions and chunks. Sampling runs
replicated: the gathered logits are bit-identical on every rank and the
ranks' generators are seeded alike, so they sample the same tokens with
no broadcast.
"""

from __future__ import annotations

import queue
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from llamagen_tpu_torch.config import GPTConfig, MLAMoEConfig, find_multiple
from llamagen_tpu_torch.models import gpt, mla_moe
from llamagen_tpu_torch.ops import (attention, mla_attention, moe,
                                    quant_matmul, sampling, w4_matmul)
from llamagen_tpu_torch.ops.attention import TAIL, quantize_rows
from llamagen_tpu_torch.ops.generate import build_cfg_batch
from llamagen_tpu_torch.utils import profiling


def family(cfg):
    """The module that allocates a model's cache and runs its decode step
    (`init_cache`, `decode_step_slots`, with one signature):
    `models/mla_moe.py` for an `MLAMoEConfig` (a latent cache, routed
    experts), else `models/gpt.py`."""
    return mla_moe if isinstance(cfg, MLAMoEConfig) else gpt


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
    prefix_pad: Optional[torch.Tensor] = None  # t2i: [P] int32 left pads


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
                      sp: Optional[SamplingParams] = None,
                      kv_heads: Optional[int] = None) -> EngineState:
    """Idle slots over a cache of find_multiple(cls + max_new, 128) rows:
    a finished slot keeps stepping at pos max_new, so every slot's position
    stays inside it. An int8 cache starts empty (zero rows, scales 1.0,
    zero tail), as the JAX engine's does. `kv_heads`: a TP shard's local
    kv heads (the cache's width)."""
    smax = find_multiple(cfg.cls_token_num + max_new_tokens, 128)
    zeros = lambda dt: torch.zeros(num_pairs, dtype=dt, device=device)
    return EngineState(
        cache=family(cfg).init_cache(cfg, 2 * num_pairs, smax, cache_dtype,
                                     device, compute_dtype=compute_dtype,
                                     kv_heads=kv_heads),
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
                       if track_counts else None),
        prefix_pad=(zeros(torch.int32) if cfg.model_type == "t2i" else None))


def build_step_embeddings(model: gpt.Transformer, state: EngineState,
                          compute_dtype: torch.dtype
                          ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Per-slot input embeddings of one step, [2P, D], the cond half over
    the uncond half, and the rows' left-pad counts [2P] (t2i; else None).
    c2i: a slot at its first step (active, pos 0) reads its class /
    null-class embedding, every other slot its last token's. t2i: the
    caption prefill ran at admission, so every slot feeds its last
    token."""
    cfg = model.cfg
    tok_emb = model.tok_embeddings.weight[state.cur_token]
    if cfg.model_type == "t2i":
        return (torch.cat([tok_emb, tok_emb]).to(compute_dtype),
                torch.cat([state.prefix_pad, state.prefix_pad]))
    table = model.cls_embedding.embedding_table.weight
    first = (state.active & (state.pos == 0))[:, None]
    emb_cond = torch.where(first, table[state.labels], tok_emb)
    emb_uncond = torch.where(first, table[cfg.num_classes], tok_emb)
    return torch.cat([emb_cond, emb_uncond]).to(compute_dtype), None


def sample_and_advance(state: EngineState, logits: torch.Tensor,
                       max_new_tokens: int, filters_off: bool = False) -> None:
    """The tail of one step, in place: CFG mix with per-slot scales,
    penalties, sampling, then the bookkeeping (write the token of every
    active unfinished slot, advance pos and n_generated, retire finished
    slots). Every tensor of the state keeps its storage (a captured step
    replays on those addresses). `filters_off`: the host knows no slot
    asks for top-k / top-p."""
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
    torch.where(write, nxt[:, None], state.tokens_out, out=state.tokens_out)
    state.n_generated.add_(going.to(torch.int32))
    torch.where(going, nxt, state.cur_token, out=state.cur_token)
    state.pos.add_(state.active.to(torch.int32))
    state.active.logical_and_(state.n_generated < max_new_tokens)
    if counts is not None:
        sampling.update_output_counts(counts, nxt, going)


def apply_admission(state: EngineState, admit_mask: torch.Tensor,
                    admit_labels: torch.Tensor,
                    admit_sp: SlotSampling) -> None:
    """Reset the admitted slots' bookkeeping and write their sampling
    parameters, in place (no tensor of the state changes its storage).
    Their cache rows need no reset: a slot reads only rows it has written
    since its admission."""
    state.pos.masked_fill_(admit_mask, 0)
    state.active.logical_or_(admit_mask)
    torch.where(admit_mask, admit_labels, state.labels, out=state.labels)
    state.n_generated.masked_fill_(admit_mask, 0)
    for a, s in zip(admit_sp, state.sp_slots):
        torch.where(admit_mask, a.to(s.dtype), s, out=s)
    if state.output_counts is not None:
        state.output_counts.masked_fill_(admit_mask[:, None], 0)


def _addresses(state: EngineState) -> Tuple[int, ...]:
    """What a captured step is bound to: the state's generator and the
    storage of every tensor of the state."""
    cache = state.cache
    tensors = [state.pos, state.active, state.cur_token, state.labels,
               state.n_generated, state.tokens_out, *state.sp_slots,
               *cache.kv, *(cache.kv_scale or ()), *(cache.tail or ())]
    tensors += [t for t in (state.output_counts, state.prefix_pad)
                if t is not None]
    return (id(state.generator),) + tuple(t.data_ptr() for t in tensors)


# the kernel wrappers whose launch counters a decode step advances (K1;
# K2 or, for W4 weights, K3; for the MLA + MoE model K6, K2 and K7)
_COUNTED = (attention.decode_attention, quant_matmul.int8_matmul,
            w4_matmul.w4_matmul, mla_attention.mla_decode_attention,
            moe.moe_int8_matmul)


class _Replay(NamedTuple):
    graph: "torch.cuda.CUDAGraph"
    launches: Tuple[int, ...]  # the captured launches of each `_COUNTED`

    def __call__(self) -> None:
        self.graph.replay()
        for fn, n in zip(_COUNTED, self.launches):
            fn.launches += n


class DecodeGraphs:
    """One decode step captured as a CUDA graph per value of the host's
    `filters_off` flag (it decides whether the [B, V] sort is in the
    step), over the tensors of one `EngineState`: a replay reads and
    writes the storage it was captured on, which the state's helpers
    (`apply_admission`, `sample_and_advance`, `scatter_pairs`) keep, and
    draws its Gumbel noise from the state's generator, registered with
    each graph, so that every replay draws afresh and advances the
    generator as the eager step would. `enabled` on a CUDA device for a
    whole model (a TP shard's all-reduces cannot be captured). A state
    with other storage drops the graphs and captures anew. Counts the
    decode steps replayed and run eagerly."""

    def __init__(self, step: Callable[[EngineState, bool], None],
                 enabled: bool):
        self.step = step
        self.enabled = enabled
        self.replays = self.eager = 0
        self._key: Optional[Tuple[int, ...]] = None
        self._graphs: Dict[bool, _Replay] = {}

    def get(self, state: EngineState, filters_off: bool
            ) -> Optional[_Replay]:
        if not self.enabled:
            return None
        key = _addresses(state)
        if key != self._key:
            self._key, self._graphs = key, {}
        return self._graphs.get(filters_off)

    def capture(self, state: EngineState, filters_off: bool
                ) -> Optional[_Replay]:
        """Capture the step (after an eager one has loaded its kernels and
        their geometry); the capture runs nothing, so the launch counters
        it advanced are set back."""
        if not self.enabled:
            return None
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(state.generator)
        before = [fn.launches for fn in _COUNTED]
        # thread_local: the app's handler threads may use the card meanwhile
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            self.step(state, filters_off)
        made = tuple(fn.launches - n for fn, n in zip(_COUNTED, before))
        for fn, n in zip(_COUNTED, before):
            fn.launches = n
        self._graphs[filters_off] = _Replay(graph, made)
        return self._graphs[filters_off]


def make_engine_step(model: gpt.Transformer, max_new_tokens: int,
                     chunk: int = 64,
                     compute_dtype: torch.dtype = torch.bfloat16):
    """The chunked engine step: engine_step(state, n_steps, filters_off)
    runs n_steps <= chunk decode steps in place (JAX clamps n_steps to the
    chunk; here a larger one raises, since the caller's mirror of the
    slots would go wrong; JAX's admission inside the step is the caller's
    `apply_admission` before it). No step reads the device from the
    host. On a CUDA device a whole model's step is captured after its
    first eager run and replayed from then on (`DecodeGraphs`,
    `engine_step.graphs`). The `engine.decode` span of a routed model
    counts its (row, expert) pairs, `routed`."""
    decode = family(model.cfg).decode_step_slots
    top_k = getattr(model.cfg, "top_k", None)

    def one_step(state: EngineState, filters_off: bool) -> None:
        emb, pad2 = build_step_embeddings(model, state, compute_dtype)
        pos2 = torch.cat([state.pos, state.pos])
        logits = decode(model, emb, pos2, state.cache, compute_dtype,
                        prefix_pad=pad2)
        sample_and_advance(state, logits, max_new_tokens, filters_off)

    graphs = DecodeGraphs(one_step, model.tp_size == 1
                          and model.freqs_cis.device.type == "cuda")

    @torch.no_grad()
    def engine_step(state: EngineState, n_steps: int,
                    filters_off: bool = False) -> EngineState:
        if n_steps > chunk:
            raise ValueError(f"{n_steps} steps, more than the chunk {chunk}")
        rows = 2 * state.pos.shape[0]
        counts = {"routed": rows * top_k} if top_k else {}
        replay = graphs.get(state, filters_off)
        for _ in range(n_steps):
            with profiling.span("engine.decode", rows=rows,
                                graphed=int(replay is not None), **counts):
                if replay is not None:
                    replay()
                else:
                    one_step(state, filters_off)
            if replay is not None:
                graphs.replays += 1
            else:
                graphs.eager += 1
                replay = graphs.capture(state, filters_off)
        return state

    engine_step.graphs = graphs
    return engine_step


class Admitted(NamedTuple):
    """An admission's results for A pairs, on the engine's device."""
    firsts: torch.Tensor     # [A] int64 first tokens
    rows: List[torch.Tensor]  # per layer [A, 2, T, 2F] (cond, uncond)
    pads: torch.Tensor       # [A] int32 left-pad counts (c2i: 0)


def prefill_pairs(model: gpt.Transformer, cond: torch.Tensor,
                  emb_masks: Optional[torch.Tensor],
                  compute_dtype: torch.dtype = torch.bfloat16
                  ) -> Tuple[torch.Tensor, List[torch.Tensor], torch.Tensor]:
    """The condition prefill of A pairs in ONE forward ([2A, T]: cond rows
    first, the null condition's second) into a staging cache: class labels
    [A] (c2i), or captions [A, T, caption_dim] with their left-pad masks
    emb_masks [A, T] (t2i). Returns (f32 logits [2A, V] at the last
    position, cache rows per layer [A, 2, T, 2F], left pads [A] int32)."""
    cfg = model.cfg
    t = cfg.cls_token_num
    a = cond.shape[0]
    m2 = None
    pads = torch.zeros(a, dtype=torch.int32, device=cond.device)
    if cfg.model_type == "t2i":
        cond = cond.to(compute_dtype)
        m = emb_masks.bool()
        m2 = torch.cat([m, m])
        pads = (t - m.sum(dim=1)).to(torch.int32)
    stage = gpt.init_cache(cfg, 2 * a, find_multiple(t, 8), compute_dtype,
                           cond.device, kv_heads=model.n_local_kv_heads)
    logits = gpt.prefill(model, build_cfg_batch(model, cond, True), stage,
                         compute_dtype, prefix_mask=m2)
    rows = [torch.stack([ckv[:a, :t], ckv[a:, :t]], dim=1)
            for ckv in stage.kv]
    return logits, rows, pads


def make_admit_batch(model: gpt.Transformer,
                     compute_dtype: torch.dtype = torch.bfloat16):
    """The admission prefill (JAX `make_admit_batch`): admit(cond, emb_masks
    [A, T] bool or None, sp_rows SlotSampling of [A] tensors, generator,
    filters_off) runs `prefill_pairs` on A pairs (the t2i engine: captions;
    the speculative engine: labels too), mixes each pair's logits with its
    own cfg scale and samples its first token. A is whatever the caller
    gives (the engines: at most min(P, 8) pairs a call). Returns
    `Admitted`."""

    @torch.no_grad()
    def admit(cond: torch.Tensor, emb_masks: Optional[torch.Tensor],
              sp_rows: SlotSampling, generator: torch.Generator,
              filters_off: bool = False) -> Admitted:
        logits, rows, pads = prefill_pairs(model, cond, emb_masks,
                                           compute_dtype)
        mixed = sampling.cfg_mix(logits, sp_rows.cfg_scale)
        firsts = sampling.sample_per_slot(mixed, sp_rows.temperature,
                                          sp_rows.top_k, sp_rows.top_p,
                                          generator, filters_off)
        return Admitted(firsts, rows, pads)

    return admit


@torch.no_grad()
def scatter_pairs(state: EngineState, cfg: GPTConfig, slots: torch.Tensor,
                  adm: Admitted, sp_rows: SlotSampling) -> None:
    """Install admitted pairs in their slots, in place (JAX
    `scatter_pair_local` for a group of pairs): slots [A] int64, the
    pairs' cache rows go to rows (slot, P + slot). A bf16/f32 cache takes
    rows [0, T); an int8 cache takes rows [0, base), base = 32 * (T // 32),
    quantised by `quantize_rows` (as `generate`'s `quantize_cache`), and
    rows [base, T) go exact into the tail. Each slot then stands at pos T
    with its first token written, n_generated 1, its left pad (t2i) and
    its sampling parameters; its penalty counts hold the first token. The
    k half's width comes from the cache (a TP rank's is its own)."""
    p = state.pos.shape[0]
    t = cfg.cls_token_num
    f = state.cache.kv[0].shape[-1] // 2
    idx = torch.cat([slots, slots + p])
    cache = state.cache
    base = t // TAIL * TAIL if cache.quantized else t
    for l, r in enumerate(adm.rows):
        r = torch.cat([r[:, 0], r[:, 1]])  # [2A, T, 2F]: cond rows first
        if cache.quantized:
            kq, ks = quantize_rows(r[:, :base, :f])
            vq, vs = quantize_rows(r[:, :base, f:])
            cache.kv[l][idx, :base] = torch.cat([kq, vq], dim=-1)
            cache.kv_scale[l][idx, :base] = torch.stack(
                [ks, vs], dim=-1).to(torch.bfloat16)
            cache.tail[l][idx, :t - base] = r[:, base:].to(
                cache.tail[l].dtype)
        else:
            cache.kv[l][idx, :t] = r.to(cache.kv[l].dtype)
    # tensor values and index_fill_ only: `x[idx] = scalar` copies the
    # scalar from the host, which synchronises
    firsts = adm.firsts
    state.pos.index_fill_(0, slots, t)
    state.active.index_fill_(0, slots, True)
    state.cur_token[slots] = firsts
    state.n_generated.index_fill_(0, slots, 1)
    row = torch.zeros(len(slots), state.tokens_out.shape[1],
                      dtype=torch.long, device=firsts.device)
    row[:, 0] = firsts
    state.tokens_out[slots] = row
    if state.prefix_pad is not None:
        state.prefix_pad[slots] = adm.pads
    for a, v in zip(state.sp_slots, sp_rows):
        a[slots] = v.to(a.dtype)
    counts = state.output_counts
    if counts is not None:
        counts.index_fill_(0, slots, 0)
        counts.index_put_((slots, firsts),
                          torch.ones_like(firsts, dtype=counts.dtype))


@dataclass
class Request:
    label: int
    request_id: int
    sp: Optional[SamplingParams] = None      # per-request override
    caption: Optional[torch.Tensor] = None   # t2i: [T, caption_dim] f32 CPU
    emb_mask: Optional[torch.Tensor] = None  # t2i: [T] bool, left-padded
    result: Optional[np.ndarray] = None
    submitted_at: float = field(default_factory=time.time)
    admitted_at: Optional[float] = None      # host time of admission
    # time.time() at which the first token was sampled, as observed on the
    # device's timeline (ServeEngine) or the host's at admission (SpecEngine)
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None


class EngineBase:
    """The request surface both engines share (`ServeEngine`, and
    `serve/spec_engine.py::SpecEngine`): `submit`, `submit_caption`,
    `generate`, `generate_t2i`, `run_until_idle` and the latency gauges of
    `stats()`, and the grouped admission of captions or labels. A subclass
    sets the attributes of `_init_requests` (and `_abatch`, `admissions`
    where it admits through `_admit_grouped`) and gives `_checked` (the
    sampling parameters it accepts) and `_cycle` (one admission, chunk and
    harvest)."""

    def _init_requests(self, cfg: GPTConfig, device: torch.device,
                       num_pairs: int, max_new_tokens: int,
                       sp: Optional[SamplingParams]) -> None:
        if not 0 < max_new_tokens <= cfg.block_size:
            raise ValueError(f"max_new_tokens {max_new_tokens} outside "
                             f"(0, block_size {cfg.block_size}]")
        self.cfg = cfg
        self.device = device
        self.num_pairs = num_pairs
        self.max_new_tokens = max_new_tokens
        self.sp = sp or SamplingParams()
        self.t2i = cfg.model_type == "t2i"
        self.slot_request: List[Optional[Request]] = [None] * num_pairs
        self.pending: "queue.Queue[Request]" = queue.Queue()
        self._next_id = 0
        self.reset_stats()

    def submit(self, label: int,
               sp: Optional[SamplingParams] = None) -> Request:
        """A c2i request; `sp` overrides the engine's sampling parameters
        for this request only."""
        if self.t2i:
            raise ValueError("a t2i engine takes captions: submit_caption")
        return self._enqueue(Request(label=int(label),
                                     request_id=self._next_id,
                                     sp=self._checked(sp)))

    def submit_caption(self, caption, emb_mask,
                       sp: Optional[SamplingParams] = None) -> Request:
        """A t2i request: caption [T, caption_dim] T5 features, left-padded
        (`text.t5.left_pad_embeddings`), and its [T] validity mask (array
        or tensor; kept on the host until admission)."""
        if not self.t2i:
            raise ValueError("a c2i engine takes class labels: submit")
        t = self.cfg.cls_token_num
        caption = torch.as_tensor(caption).to("cpu", torch.float32)
        emb_mask = torch.as_tensor(emb_mask).to("cpu").bool()
        if caption.shape != (t, self.cfg.caption_dim) \
                or emb_mask.shape != (t,):
            raise ValueError(f"caption {tuple(caption.shape)} / mask "
                             f"{tuple(emb_mask.shape)}, expected "
                             f"{(t, self.cfg.caption_dim)} / {(t,)}")
        return self._enqueue(Request(label=0, request_id=self._next_id,
                                     sp=self._checked(sp), caption=caption,
                                     emb_mask=emb_mask))

    def _checked(self, sp: Optional[SamplingParams]) -> SamplingParams:
        raise NotImplementedError

    def _cycle(self) -> None:
        raise NotImplementedError

    def _enqueue(self, req: Request) -> Request:
        self._next_id += 1
        self.pending.put(req)
        return req

    def _to_device(self, host: torch.Tensor) -> torch.Tensor:
        """One host-to-device copy that does not synchronise (pinned,
        asynchronous)."""
        if self.device.type == "cuda":
            host = host.pin_memory()
        return host.to(self.device, non_blocking=True)

    def _admit_grouped(self, taken: List[Tuple[int, "Request"]],
                       install: Callable[..., None]) -> None:
        """Admission of (slot, request) pairs, a group of at most
        `_abatch` pairs at a time: a group's slots, labels, sampling
        parameters and (t2i) masks go to the device in one asynchronous
        copy, its captions in a second; then install(slots, cond, masks,
        sp_rows, filters_off) runs the subclass's prefill and slot scatter.
        cond: labels [G] (c2i) or captions [G, T, caption_dim] (t2i);
        masks: [G, T] bool, None for c2i."""
        n = 2 + len(SlotSampling._fields)  # slot, label, the parameters
        for start in range(0, len(taken), self._abatch):
            grp = taken[start:start + self._abatch]
            with profiling.span("engine.admit", pairs=len(grp)):
                packed = torch.stack([torch.cat([
                    torch.tensor([i, req.label] + req.sp.row()),
                    req.emb_mask.float() if self.t2i else torch.zeros(0)])
                    for i, req in grp])
                dev = self._to_device(packed)
                if self.t2i:
                    cond = self._to_device(torch.stack([req.caption
                                                        for _, req in grp]))
                    masks = dev[:, n:] > 0
                else:
                    cond, masks = dev[:, 1].long(), None
                install(dev[:, 0].long(), cond, masks,
                        SlotSampling(*dev[:, 2:n].t()),
                        all(req.sp.filters_off for _, req in grp))
            self._admitted([req for _, req in grp])
            self.admissions += 1

    def _admitted(self, reqs: List["Request"]) -> None:
        """The work launched so far admitted `reqs` and sampled their first
        tokens (`ServeEngine` stamps and observes them; the speculative
        engine stamps its whole admission at once instead)."""

    def _finish(self, i: int, tokens: np.ndarray) -> None:
        """Slot i's request is done: its result, latency and TTFT samples
        (`first_token_at` set by the subclass); the slot is free."""
        req = self.slot_request[i]
        req.result = tokens.copy()
        req.finished_at = time.time()
        self._latencies.append(req.finished_at - req.submitted_at)
        self._ttfts.append(req.first_token_at - req.submitted_at)
        self._completed += 1
        self.slot_request[i] = None

    def run_until_idle(self) -> None:
        """Process everything in the queue to completion."""
        while (not self.pending.empty()
               or any(r is not None for r in self.slot_request)):
            self._cycle()

    def generate(self, labels) -> np.ndarray:
        """Offline batch: labels [N] -> token grids [N, max_new_tokens], in
        submission order."""
        reqs = [self.submit(l) for l in labels]
        self.run_until_idle()
        return np.stack([r.result for r in reqs])

    def generate_t2i(self, captions, emb_masks) -> np.ndarray:
        """Offline t2i batch: captions [N, T, caption_dim] + emb_masks
        [N, T] -> token grids [N, max_new_tokens], in submission order."""
        reqs = [self.submit_caption(c, m) for c, m in zip(captions,
                                                           emb_masks)]
        self.run_until_idle()
        return np.stack([r.result for r in reqs])

    def reset_stats(self) -> None:
        """Zero the stats() gauges (latency and TTFT samples, completions,
        the throughput clock), e.g. after a warm-up."""
        self._latencies: List[float] = []
        self._ttfts: List[float] = []
        self._completed = 0
        self._started = time.time()

    def _gauges(self, running: int, **extra) -> Dict[str, Any]:
        """The JAX engine's gauges: running / waiting counts, slot
        occupancy, completions, throughput, then `extra`, then e2e latency,
        TTFT and TPOT (time per output token after the first)."""
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
            "running": running,
            "waiting": self.pending.qsize(),
            "slots": self.num_pairs,
            "slot_occupancy": running / self.num_pairs,
            "completed": self._completed,
            "throughput_img_per_s": self._completed / elapsed,
            **extra,
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


class ServeEngine(EngineBase):
    """Host-side request loop over the chunked step: `submit` + `run_until_
    idle` for online serving, `generate` for an offline batch. The model's
    device is the engine's device.

    tp > 1 (JAX's `mesh` / `tp`): `model` is this rank's TP shard with its
    process group (`shard_tp_params(model, rank, tp, group)`); without the
    group, or for a model sharded another number of ways, it raises.
    `mesh`, where given, must have that tp. Every rank submits the same
    requests (module docstring).

    `model` may also be an `models/mla_moe.py::MLAMoETransformer` (a
    bf16 or f32 latent cache, one device, no TP); its `stats()` then adds
    `moe_expert_rows`, the rows each routed layer sent to each expert
    since `reset_stats`."""

    def __init__(self, model: gpt.Transformer, *, num_pairs: int = 16,
                 max_new_tokens: int = 576,
                 sampling_params: Optional[SamplingParams] = None,
                 chunk: int = 64, seed: int = 0,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 cache_dtype: Optional[torch.dtype] = None,
                 track_penalties: bool = False, mesh=None, tp: int = 1):
        routed = isinstance(model.cfg, MLAMoEConfig)
        if routed and (tp != 1 or mesh is not None):
            raise NotImplementedError("the MLA + MoE model serves on one "
                                      "device: no tensor parallelism")
        if tp != model.tp_size or (mesh is not None
                                   and mesh["tp"].size() != tp):
            raise ValueError(f"tp {tp}, a model sharded {model.tp_size} "
                             f"ways, mesh {mesh}: shard_tp_params first")
        gpt.tp_group_of(model)  # a TP shard without its group raises
        self.step_fn = make_engine_step(model, max_new_tokens, chunk,
                                        compute_dtype)
        self._graphs = self.step_fn.graphs
        self._expert_rows = model.expert_rows if routed else None
        self._init_requests(model.cfg, model.freqs_cis.device, num_pairs,
                            max_new_tokens, sampling_params)
        cfg = self.cfg
        self.chunk = chunk
        self.state = init_engine_state(
            cfg, num_pairs, max_new_tokens,
            torch.Generator(device=self.device).manual_seed(seed),
            self.device, cache_dtype=cache_dtype or compute_dtype,
            compute_dtype=compute_dtype,
            track_counts=self.sp.uses_penalties or track_penalties,
            sp=self.sp, kv_heads=None if routed else model.n_local_kv_heads)
        self.cache_rows = self.state.cache.kv[0].shape[1]
        # host mirror of each slot's progress (it advances deterministically)
        # sizes the chunks, checks the cache bounds and gates the filters
        # without reading the device
        self._slot_remaining = np.zeros((num_pairs,), np.int64)
        self._slot_pos = np.zeros((num_pairs,), np.int64)
        self._slot_filters_off = np.ones((num_pairs,), bool)
        # the first-token events of the running requests, by request id
        self._first_events: Dict[int, torch.cuda.Event] = {}
        # the end of the last chunk launched (on the card)
        self._chunk_end: Optional[torch.cuda.Event] = None
        self.steps_run = 0  # decode steps since construction (host count)
        self.admissions = 0  # t2i admission prefills (host count)
        if self.t2i:
            # batched admission: one prefill for up to _abatch pending pairs
            self._abatch = min(num_pairs, 8)
            self._admit_fn = make_admit_batch(model, compute_dtype)

    def _checked(self, sp: Optional[SamplingParams]) -> SamplingParams:
        """Per-request penalties need the engine built with
        track_penalties=True (the counts buffer)."""
        sp = sp or self.sp
        if sp.uses_penalties and self.state.output_counts is None:
            raise ValueError("per-request penalties need ServeEngine("
                             "track_penalties=True)")
        return sp

    def _admission(self, admitted: Dict[int, Request]):
        """(mask, labels, SlotSampling) on the device from one host copy
        (pinned, asynchronous): no synchronising transfer."""
        packed = np.zeros((2 + len(SlotSampling._fields), self.num_pairs),
                          np.float32)
        for i, req in admitted.items():
            packed[:, i] = [1.0, req.label] + req.sp.row()
        dev = self._to_device(torch.from_numpy(packed))
        return dev[0] > 0, dev[1].long(), SlotSampling(*dev[2:])

    def _admit_captions(self, taken: List[Tuple[int, Request]]) -> None:
        """t2i admission of (slot, request) pairs: one `make_admit_batch`
        prefill per group of at most _abatch pairs, then `scatter_pairs`."""
        def install(slots, caps, masks, sp_rows, filters_off):
            adm = self._admit_fn(caps, masks, sp_rows, self.state.generator,
                                 filters_off)
            scatter_pairs(self.state, self.cfg, slots, adm, sp_rows)

        self._admit_grouped(taken, install)

    def reset_stats(self) -> None:
        """`EngineBase.reset_stats`; on the card also the anchor that puts
        the first-token events on the host clock: an event recorded on an
        idle stream (after a sync) beside time.time()."""
        super().reset_stats()
        self._decode_base = (self._graphs.replays, self._graphs.eager)
        if self._expert_rows is not None:
            self._expert_rows.zero_()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            self._anchor = self._event()
            self._anchor_at = time.time()

    def _event(self) -> torch.cuda.Event:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def _admitted(self, reqs: List[Request]) -> None:
        """A t2i admission group's launches are issued: its requests are
        admitted now, and their first tokens observed behind it."""
        now = time.time()
        for req in reqs:
            req.admitted_at = now
        self._first_token(reqs)

    def _first_token(self, reqs: List[Request]) -> None:
        """The work launched so far sampled the first token of `reqs`: on
        the card an event behind it (`_harvest` reads it against the
        anchor), on the CPU the host clock now."""
        if self.device.type != "cuda":
            now = time.time()
            for req in reqs:
                req.first_token_at = now
            return
        ev = self._event()
        for req in reqs:
            self._first_events[req.request_id] = ev

    def _admit_and_step(self) -> None:
        with profiling.span("engine.admit_and_step") as span:
            if self._chunk_end is not None:
                # graph replays return at once: without this wait a cycle
                # with nothing to harvest would queue chunk after chunk, and
                # a request would be admitted (and stamped) seconds before
                # its slot starts, new arrivals behind the whole queue
                self._chunk_end.synchronize()
            admitted: Dict[int, Request] = {}
            for i in range(self.num_pairs):
                if self.slot_request[i] is not None or self.pending.empty():
                    continue
                req = self.pending.get()
                self.slot_request[i] = admitted[i] = req
                # a t2i slot samples its first token at admission and then
                # decodes from position T
                self._slot_remaining[i] = self.max_new_tokens - self.t2i
                self._slot_pos[i] = self.cfg.cls_token_num if self.t2i else 0
                self._slot_filters_off[i] = req.sp.filters_off
            if self.t2i and admitted:  # stamped group by group
                self._admit_captions(list(admitted.items()))
            # exact-step chunking: run until the next slot finishes (or the
            # chunk cap), so no finished slot idles through a fixed chunk
            busy = self._slot_remaining > 0
            n_steps = int(min(self._slot_remaining[busy].min(),
                              self.chunk)) if busy.any() else 0
            span.count(steps=n_steps)
            # the highest cache row each slot writes in this chunk: busy
            # slots advance n_steps, idle ones step at their fixed position
            last = self._slot_pos + np.where(busy, n_steps - 1, 0)
            if last.max() >= self.cache_rows:  # K1 would write past it
                raise RuntimeError(f"slot rows {last} outside the cache of "
                                   f"{self.cache_rows}")
            filters_off = bool(all(self._slot_filters_off[i]
                                   for i in range(self.num_pairs)
                                   if self.slot_request[i] is not None))
            first = 0
            if admitted and not self.t2i:
                now = time.time()
                for req in admitted.values():
                    req.admitted_at = now
                with profiling.span("engine.admit", pairs=len(admitted)):
                    apply_admission(self.state, *self._admission(admitted))
                # the chunk's first step samples their first tokens
                self.state = self.step_fn(self.state, 1, filters_off)
                self._first_token(list(admitted.values()))
                first = 1
            self.state = self.step_fn(self.state, n_steps - first,
                                      filters_off)
            self.steps_run += n_steps
            self._slot_pos[busy] += n_steps
            self._slot_remaining[busy] -= n_steps
            if self.device.type == "cuda":
                self._chunk_end = torch.cuda.Event()
                self._chunk_end.record(torch.cuda.current_stream(self.device))

    def _harvest(self) -> None:
        with profiling.span("engine.harvest") as span:
            done = [i for i in range(self.num_pairs)
                    if self.slot_request[i] is not None
                    and self._slot_remaining[i] == 0]
            span.count(done=len(done))
            if not done:
                return
            with profiling.span("engine.harvest.read"):
                # one read a harvest: it waits for every step launched
                tokens = self.state.tokens_out.cpu().numpy()
            for i in done:
                req = self.slot_request[i]
                ev = self._first_events.pop(req.request_id, None)
                if ev is not None:
                    req.first_token_at = self._anchor_at \
                        + self._anchor.elapsed_time(ev) / 1e3
                self._finish(i, tokens[i])

    def _cycle(self) -> None:
        self._admit_and_step()
        self._harvest()

    def stats(self) -> Dict[str, Any]:
        """The gauges (`EngineBase._gauges`), read from the host mirror: no
        device read; then `decode_graphed_share`, the share of the decode
        steps since `reset_stats` that were graph replays (None before
        the first step); for a routed model `moe_expert_rows` [routed
        layers][experts], the one device read."""
        replays = self._graphs.replays - self._decode_base[0]
        steps = replays + self._graphs.eager - self._decode_base[1]
        out = {**self._gauges(int((self._slot_remaining > 0).sum())),
               "decode_graphed_share": replays / steps if steps else None}
        if self._expert_rows is not None:
            out["moe_expert_rows"] = self._expert_rows.tolist()
        return out
