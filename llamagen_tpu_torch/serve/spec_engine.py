"""Speculative serving engine: draft / verify rounds over the slots.

Counterpart of `llamagen_tpu/serve/spec_engine.py` (one device). Each
ROUND (in place of `serve/engine.py`'s per-token step) runs, for every
slot at once:

    k + 1 draft steps (C = 1)  ->  k proposals (the extra step keeps the
                                   draft cache complete in all-accept rounds)
    one target verify (C = k+1) -> each slot commits 1 .. k + 1 tokens
                                   (`spec_accept_per_slot`)

so the target reads its weights once per 1 .. k + 1 committed tokens. The
configuration it is built for is a W4 copy of a W8A16 model drafting for
it (self-speculation): the draft's layer matmuls run the W4 kernel
(`ops/w4_matmul.py`) at 2P rows, the target's the int8 kernel
(`ops/quant_matmul.py`) at 2P * (k + 1) rows, and every draft and verify
step runs the chunk-attention kernel (`ops/chunk_attention.py`) at the
slots' own positions, through `ops/speculative.py::verify_step_slots`.

Differences from `serve/engine.py::ServeEngine`:
  - slots advance a data-dependent number of tokens a round, so the host
    cannot mirror their progress: after each chunk of rounds it reads the
    [P] `n_generated` vector once (`_sync`) and harvests and admits on
    that. A chunk is sized by the all-accept lower bound on the rounds
    until the next slot can finish, capped by `chunk_rounds`; no
    device-to-host read happens inside it.
  - admission runs out of band for c2i and t2i alike
    (`make_spec_admit_batch`, `spec_scatter`): one batched prefill of the
    condition into BOTH models' staging caches, the first token sampled
    from the target's CFG-mixed logits with the request's own parameters.
  - caches are bf16 or f32 (the chunk kernel refuses int8), of
    T + max_new + (k + 1) + 16 rows: a finished or idle slot keeps stepping
    at a frozen position (its quota caps `n_new` before `pos` advances), so
    no draft or verify row passes the cache. JAX aligns the size to 128
    rows for its epoch tiles; the port's kernel writes single rows.
  - per-request cfg scale, temperature, top-k and top-p are per-slot
    tensors; greedy rows (temperature <= 0) take the argmax-chain
    acceptance, row by row beside sampled rows.
  - penalties are refused (their sequential counts break the parallel
    verify), as are a draft of another vocabulary or conditioning geometry
    and tensor parallelism (`mesh` / `tp`).

Random streams: one `torch.Generator` on the engine's device for the
rounds (seed) and one for the admissions (seed + 1), as JAX splits
`PRNGKey(seed)` and `PRNGKey(seed + 1)`.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from llamagen_tpu_torch.config import GPTConfig
from llamagen_tpu_torch.models import gpt
from llamagen_tpu_torch.ops import sampling
from llamagen_tpu_torch.ops.speculative import spec_accept, verify_step_slots
from llamagen_tpu_torch.serve.engine import (Admitted, EngineBase,
                                             EngineState, Request,
                                             SamplingParams, SlotSampling,
                                             make_admit_batch, prefill_pairs,
                                             scatter_pairs, slot_sampling_full)


@dataclass
class SpecEngineState(EngineState):
    """`EngineState` with the draft's cache beside the target's (`cache`),
    both bf16 / f32 with 2P rows (cond rows first). `pos` is the position
    of each slot's last committed token, which neither cache holds yet;
    `tokens_out` has a trash column at max_new for masked writes."""
    dcache: Optional[gpt.KVCache] = None


def warped_probs_per_slot(logits: torch.Tensor, temperature: torch.Tensor,
                          top_k: torch.Tensor, top_p: torch.Tensor,
                          filters_off: bool = False) -> torch.Tensor:
    """The per-slot `ops.speculative.warped_probs`: logits [P, V] or
    [P, C, V], parameters [P] -> f32 probabilities of the same shape.

    Exactly the distribution `sampling.sample_per_slot` draws from (the
    temperature clamped at 1e-5, the same per-row filters, skipped when
    the host knows every row has them off): acceptance must test against
    the distributions the tokens are drawn from. A greedy row's softmax at
    the clamped temperature keeps its logits' argmax."""
    shape = logits.shape
    v = shape[-1]
    lg = logits.float().reshape(shape[0], -1, v)
    c = lg.shape[1]
    lg = lg / temperature.float().clamp_min(1e-5)[:, None, None]
    flat = lg.reshape(-1, v)
    if not filters_off:
        flat = sampling.filter_logits_per_slot(
            flat, top_k[:, None].expand(-1, c).reshape(-1),
            top_p[:, None].expand(-1, c).reshape(-1))
    return torch.softmax(flat, dim=-1).reshape(shape)


def spec_accept_per_slot(proposals: torch.Tensor, q_probs: torch.Tensor,
                         p_probs: torch.Tensor, greedy: torch.Tensor,
                         generator: Optional[torch.Generator] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`ops.speculative.spec_accept` with a per-row greedy flag [P] bool.

    Sampled rows take the accept / residual-resample rule, greedy rows the
    argmax chain (accept while the proposal is the target's argmax, then
    commit the target's argmax), not the limit of the sampled rule as the
    temperature goes to 0 (which draws uniformly among tied logits). Both
    are computed and chosen row by row. p_probs' argmax is the mixed
    logits' (a softmax at any positive temperature keeps the order and the
    first of ties)."""
    tokens_s, n_s = spec_accept(proposals, q_probs, p_probs, generator,
                                sample_logits=True)
    tokens_g, n_g = spec_accept(proposals, q_probs, p_probs,
                                sample_logits=False)
    return (torch.where(greedy[:, None], tokens_g, tokens_s),
            torch.where(greedy, n_g, n_s))


def make_spec_engine_step(target: gpt.Transformer, draft: gpt.Transformer,
                          max_new_tokens: int, k: int, chunk_rounds: int,
                          compute_dtype: torch.dtype = torch.bfloat16,
                          force_accept: Optional[int] = None):
    """The chunked speculative step: spec_chunk(state, n_rounds,
    filters_off) runs n_rounds <= chunk_rounds rounds in place (a larger
    n_rounds raises) and reads nothing back to the host. Finished and idle
    slots step at their frozen positions; their writes land on rows above
    their committed prefix and their outputs are masked. `filters_off`:
    the host knows no slot asks for top-k / top-p. force_accept (benchmark
    harness only) commits exactly min(force_accept, k) + 1 tokens a slot
    and round whatever the acceptance test says."""
    c = k + 1

    def dbl(x):
        return torch.cat([x, x])

    def one_round(state: SpecEngineState, filters_off: bool) -> None:
        p, ss = state.pos, state.sp_slots
        dev = p.device
        pad2 = None if state.prefix_pad is None else dbl(state.prefix_pad)
        warp = (ss.temperature, ss.top_k, ss.top_p)

        props, qps, cur_d = [], [], state.cur_token
        for j in range(k + 1):  # K5 at C 1 in every draft layer
            logits = verify_step_slots(draft, dbl(cur_d)[:, None],
                                       dbl(p + j), state.dcache,
                                       compute_dtype, pad2)[:, 0]
            mixed = sampling.cfg_mix(logits, ss.cfg_scale)
            qps.append(warped_probs_per_slot(mixed, *warp, filters_off))
            cur_d = sampling.sample_per_slot(mixed, *warp, state.generator,
                                             filters_off)
            props.append(cur_d)
        props = torch.stack(props[:k], dim=1)                  # [P, k]
        qps = torch.stack(qps[:k], dim=1)                      # [P, k, V]

        toks = torch.cat([state.cur_token[:, None], props], dim=1)
        vlogits = verify_step_slots(target, dbl(toks), dbl(p), state.cache,
                                    compute_dtype, pad2)       # [2P, C, V]
        cond, uncond = vlogits.chunk(2, dim=0)
        vmixed = uncond + (cond - uncond) * ss.cfg_scale[:, None, None]
        pps = warped_probs_per_slot(vmixed, *warp, filters_off)
        tokens, n_new = spec_accept_per_slot(props, qps, pps,
                                             ss.temperature <= 0.0,
                                             state.generator)
        jc = torch.arange(c, device=dev)
        if force_accept is not None:
            n_forced = min(force_accept, k) + 1
            final = tokens.gather(1, (n_new - 1)[:, None])
            tokens = torch.where(jc[None, :] < n_forced - 1,
                                 F.pad(props, (0, 1)), final)
            n_new = torch.full_like(n_new, n_forced)

        n_gen = state.n_generated.long()
        going = state.active & (n_gen < max_new_tokens)
        # the quota caps n_new BEFORE pos advances: a finishing slot stops
        # at its last token, so its frozen draft and verify rows stay
        # inside the cache of T + max_new + C + 16 rows
        n_new = torch.minimum(torch.where(going, n_new, 0),
                              max_new_tokens - n_gen)
        widx = n_gen[:, None] + jc[None, :]
        valid = (jc[None, :] < n_new[:, None]) & (widx < max_new_tokens)
        state.tokens_out.scatter_(
            1, torch.where(valid, widx, max_new_tokens), tokens)
        n_gen = n_gen + n_new
        last = tokens.gather(1, (n_new - 1).clamp_min(0)[:, None])[:, 0]
        state.cur_token = torch.where(going, last, state.cur_token)
        state.pos = (p + n_new).to(torch.int32)
        state.n_generated = n_gen.to(torch.int32)
        state.active = state.active & (n_gen < max_new_tokens)

    @torch.no_grad()
    def spec_chunk(state: SpecEngineState, n_rounds: int,
                   filters_off: bool = False) -> SpecEngineState:
        if n_rounds > chunk_rounds:
            raise ValueError(f"{n_rounds} rounds, more than the chunk "
                             f"{chunk_rounds}")
        for _ in range(n_rounds):
            one_round(state, filters_off)
        return state

    return spec_chunk


def make_spec_admit_batch(target: gpt.Transformer, draft: gpt.Transformer,
                          compute_dtype: torch.dtype = torch.bfloat16):
    """Admission into both caches (JAX `make_spec_admit_batch`):
    admit(cond, emb_masks, sp_rows, generator, filters_off) runs the target's
    `engine.make_admit_batch` (its prefill of the A pairs, each first token
    sampled from the target's CFG-mixed logits with the pair's own
    parameters) and the draft's `engine.prefill_pairs` on the same
    conditions. Returns (the target's `Admitted`, the draft's cache rows
    per layer [A, 2, T, 2F_d])."""
    target_admit = make_admit_batch(target, compute_dtype)

    @torch.no_grad()
    def admit(cond: torch.Tensor, emb_masks: Optional[torch.Tensor],
              sp_rows: SlotSampling, generator: torch.Generator,
              filters_off: bool = False
              ) -> Tuple[Admitted, List[torch.Tensor]]:
        adm = target_admit(cond, emb_masks, sp_rows, generator, filters_off)
        _, rows_d, _ = prefill_pairs(draft, cond, emb_masks, compute_dtype)
        return adm, rows_d

    return admit


@torch.no_grad()
def spec_scatter(state: SpecEngineState, cfg: GPTConfig, slots: torch.Tensor,
                 adm: Admitted, rows_d: List[torch.Tensor],
                 sp_rows: SlotSampling) -> None:
    """Install admitted pairs in their slots, in place (JAX
    `make_spec_scatter`): the target's rows and the slots' bookkeeping by
    `engine.scatter_pairs`, the draft's rows [0, T) into its cache rows
    (slot, P + slot)."""
    t = cfg.cls_token_num
    scatter_pairs(state, cfg, slots, adm, sp_rows)
    idx = torch.cat([slots, slots + state.pos.shape[0]])
    for ckv, r in zip(state.dcache.kv, rows_d):
        ckv[idx, :t] = torch.cat([r[:, 0], r[:, 1]]).to(ckv.dtype)


class SpecEngine(EngineBase):
    """Host-side speculative serving loop: the request surface of
    `ServeEngine` (`submit`, `submit_caption`, `generate`, `generate_t2i`,
    `run_until_idle`, `stats`), minus penalties. `draft` shares the
    target's vocabulary and conditioning geometry: a smaller GPT, or a W4
    copy of the target (`ops/gptq.py`, `ops/w4_matmul.py`) drafting for its
    W8A16 parent. Both models live on the engine's device."""

    def __init__(self, target: gpt.Transformer, draft: gpt.Transformer, *,
                 num_pairs: int = 8, max_new_tokens: int = 576, k: int = 4,
                 sampling_params: Optional[SamplingParams] = None,
                 chunk_rounds: int = 16, seed: int = 0,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 force_accept: Optional[int] = None,
                 mesh=None, tp: int = 1):
        if mesh is not None or tp != 1 or target.tp_size != 1 \
                or draft.tp_size != 1:
            raise NotImplementedError(
                "SpecEngine runs on one device, as the JAX engine does: "
                "tensor-parallel serving is ServeEngine(model, tp=) on a "
                "TP shard (parallel/tp_decode.py::shard_tp_params)")
        cfg, dcfg = target.cfg, draft.cfg
        if dcfg.vocab_size != cfg.vocab_size:
            raise ValueError("the draft and the target vocabularies must "
                             "match")
        if dcfg.cls_token_num != cfg.cls_token_num \
                or dcfg.model_type != cfg.model_type:
            raise ValueError("the draft must share the target's "
                             "conditioning geometry")
        if compute_dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"caches are bf16 or f32, not {compute_dtype}")
        self._init_requests(cfg, target.freqs_cis.device, num_pairs,
                            max_new_tokens, sampling_params)
        self._checked(self.sp)
        self.k = k
        self.chunk_rounds = chunk_rounds
        t = cfg.cls_token_num
        self.cache_rows = t + max_new_tokens + (k + 1) + 16
        dev = self.device
        zeros = lambda dt: torch.zeros(num_pairs, dtype=dt, device=dev)
        self.state = SpecEngineState(
            cache=gpt.init_cache(cfg, 2 * num_pairs, self.cache_rows,
                                 compute_dtype, dev),
            dcache=gpt.init_cache(dcfg, 2 * num_pairs, self.cache_rows,
                                  compute_dtype, dev),
            pos=zeros(torch.int32), active=zeros(torch.bool),
            cur_token=zeros(torch.long), labels=zeros(torch.long),
            n_generated=zeros(torch.int32),
            tokens_out=torch.zeros(num_pairs, max_new_tokens + 1,
                                   dtype=torch.long, device=dev),
            generator=torch.Generator(device=dev).manual_seed(seed),
            sp_slots=slot_sampling_full(self.sp, num_pairs, dev),
            prefix_pad=zeros(torch.int32) if self.t2i else None)
        self._admit_gen = torch.Generator(device=dev).manual_seed(seed + 1)
        self.step_fn = make_spec_engine_step(target, draft, max_new_tokens,
                                             k, chunk_rounds, compute_dtype,
                                             force_accept)
        self._abatch = min(num_pairs, 8)
        self._admit_fn = make_spec_admit_batch(target, draft, compute_dtype)
        # the host's copy of n_generated, read once a chunk (`_sync`)
        self._n_gen_host = np.zeros((num_pairs,), np.int64)
        self._slot_filters_off = np.ones((num_pairs,), bool)
        self._chunk_busy = np.zeros((num_pairs,), bool)
        self.rounds = 0          # rounds run (host count)
        self.admissions = 0      # admission prefills (host count)

    def _checked(self, sp: Optional[SamplingParams]) -> SamplingParams:
        sp = sp or self.sp
        if sp.uses_penalties:
            raise ValueError("speculative serving does not take penalties: "
                             "their counts change within a verified chunk")
        return sp

    def _admit(self) -> None:
        """Free slots take pending requests: one admission prefill per
        group of at most min(P, 8) pairs (`EngineBase._admit_grouped`, no
        synchronising transfer), then `spec_scatter`. The prefill samples
        each request's first token, so its TTFT is stamped here, on the
        host clock once the admission is issued."""
        taken: List[Tuple[int, Request]] = []
        for i in range(self.num_pairs):
            if self.slot_request[i] is None and not self.pending.empty():
                req = self.pending.get()
                self.slot_request[i] = req
                taken.append((i, req))
                self._n_gen_host[i] = 1
                self._slot_filters_off[i] = req.sp.filters_off

        def install(slots, cond, masks, sp_rows, filters_off):
            adm, rows_d = self._admit_fn(cond, masks, sp_rows,
                                         self._admit_gen, filters_off)
            spec_scatter(self.state, self.cfg, slots, adm, rows_d, sp_rows)

        self._admit_grouped(taken, install)
        now = time.time()
        for _, req in taken:
            req.admitted_at = req.first_token_at = now

    def _run_chunk(self) -> int:
        """One chunk of rounds over the busy slots, with no device read:
        the all-accept lower bound on the rounds until the next slot can
        finish, capped by chunk_rounds. Returns the rounds run."""
        busy = np.array([r is not None for r in self.slot_request])
        self._chunk_busy = busy
        if not busy.any():
            return 0
        remaining = self.max_new_tokens - self._n_gen_host[busy]
        n_rounds = min(max(1, math.ceil(int(remaining.min())
                                        / (self.k + 1))), self.chunk_rounds)
        self.state = self.step_fn(self.state, n_rounds,
                                  bool(self._slot_filters_off[busy].all()))
        self.rounds += n_rounds
        self._slot_rounds += int(busy.sum()) * n_rounds
        return n_rounds

    def _sync(self) -> None:
        """The chunk's one device read: n_generated [P]."""
        n_gen = self.state.n_generated.cpu().numpy().astype(np.int64)
        busy = self._chunk_busy
        self._tokens_committed += int((n_gen[busy]
                                       - self._n_gen_host[busy]).sum())
        self._n_gen_host[:] = n_gen

    def _harvest(self) -> None:
        done = [i for i in range(self.num_pairs)
                if self.slot_request[i] is not None
                and self._n_gen_host[i] >= self.max_new_tokens]
        if not done:
            return
        tokens = self.state.tokens_out.cpu().numpy()  # one read a harvest
        for i in done:
            self._finish(i, tokens[i, :self.max_new_tokens])

    def _cycle(self) -> None:
        self._admit()
        if self._run_chunk():
            self._sync()
        self._harvest()

    def reset_stats(self) -> None:
        super().reset_stats()
        self._slot_rounds = 0       # sum over chunks of busy slots * rounds
        self._tokens_committed = 0  # tokens the busy slots committed

    def stats(self) -> Dict[str, Any]:
        """`ServeEngine`'s gauges plus the JAX engine's `rounds`,
        `tokens_per_round_per_slot` (committed tokens per busy slot and
        round; slots that finish inside a chunk count their frozen rounds,
        a mild underestimate) and `acceptance_rate` ((tokens per round - 1)
        / k, clipped to [0, 1]). Read on the host: no device read. TTFT is
        the host clock at admission (`_admit`); `ServeEngine` observes
        when the device sampled the first token instead, so the two
        engines' `ttft_*` are not the same reading. Its rounds are never
        captured as graphs: `decode_graphed_share` reads 0 once a round
        has run."""
        tpr = (self._tokens_committed / self._slot_rounds
               if self._slot_rounds else None)
        acc = (None if tpr is None or self.k == 0
               else max(0.0, min(1.0, (tpr - 1) / self.k)))
        running = sum(r is not None for r in self.slot_request)
        return {**self._gauges(running, rounds=self.rounds,
                               tokens_per_round_per_slot=tpr,
                               acceptance_rate=acc),
                "decode_graphed_share": 0.0 if self._slot_rounds else None}
