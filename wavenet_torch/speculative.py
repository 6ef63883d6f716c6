"""Speculative sampling for WaveNet (draft proposes, target verifies).

Counterpart of ``wavenet_tpu/speculative.py``. Each segment:

1. a small draft WaveNet proposes k codes with ``sample.sampler_step``
   (k + 1 steps, consuming ``[last, c_0 .. c_{k-1}]``; each step's layer
   inputs are kept);
2. the target verifies the k proposals and the bonus position in one
   window pass (``sample._extend_forward``);
3. modified rejection sampling accepts a prefix of m proposals
   (``u * p_draft <= p_target``) and draws one corrected or bonus code
   from the residual ``max(p_target - p_draft, 0)`` (from ``p_target``
   when all k are accepted), so every emitted code is distributed as the
   target's;
4. both models commit ``m + 1`` inputs with ``sample._extend_commit``; the
   draft's window columns are its collected layer inputs, with no second
   stack pass.

The segments run in a Python loop (the JAX package's ``lax.while_loop``),
in plain PyTorch, as the JAX package runs them in XLA: no decode kernel
is launched. Randomness comes from an explicit ``torch.Generator`` on the
state's device, drawn in a fixed order within a segment (the draft's k
Gumbel draws, k uniforms, the residual's Gumbel draw); categorical draws
are Gumbel-argmax (``sample.sample_gumbel``). The draft steps a copy of
its ring, and the commits write new rings, so no state given to a call is
written. Lanes of ``batch_size > 1`` are independent loops, each with its
own generator (``lane_generators``), and each emits what its solo run
with that generator would.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import torch

from wavenet_torch.models.config import WaveNetConfig
from wavenet_torch.models.wavenet import Params, embed_gc
from wavenet_torch.sample import (
    SamplerState, _extend_commit, _extend_forward, _featurize,
    _ordered_ring, prefill_state, sample_gumbel, sampler_step,
    unseeded_prime)


class SpeculativeCarry(NamedTuple):
    """State between resumable speculative segments (batch 1)."""
    t_state: SamplerState     # target ring, causal register, t
    d_state: SamplerState     # draft ring, causal register, t
    last: torch.Tensor        # [1] int32: the next decode input


def check_models(config: WaveNetConfig, draft_config: WaveNetConfig) -> None:
    """Raise where the JAX package's ``generate_speculative`` raises: scalar
    input or local conditioning on either model, or a draft with other
    ``quantization_channels``."""
    c, dc = config, draft_config
    if c.scalar_input or dc.scalar_input:
        raise NotImplementedError(
            "speculative decoding is mu-law-only (the autoregressive "
            "inputs are the emitted class codes)")
    if c.lc_enabled or dc.lc_enabled:
        raise NotImplementedError(
            "speculative decoding does not take a local-conditioning "
            "stream; use sample.generate for lc models")
    if dc.quantization_channels != c.quantization_channels:
        raise ValueError("draft and target must share "
                         "quantization_channels")


def lane_generators(key: torch.Generator, n: int) -> List[torch.Generator]:
    """``n`` independent generators seeded from ``key``'s next draws, on
    its device: the lanes of a batched run (the JAX package's
    ``jax.random.split(key, n)``)."""
    seeds = torch.randint(0, 2 ** 62, (n,), generator=key,
                          device=key.device).tolist()
    return [torch.Generator(device=key.device).manual_seed(int(s))
            for s in seeds]


def _speculative_loop(params: Params, config: WaveNetConfig,
                      draft_params: Params, draft_config: WaveNetConfig,
                      t_state: SamplerState, d_state: SamplerState,
                      last: torch.Tensor, key: torch.Generator,
                      n_samples: int, k: int, temperature: float,
                      gc_emb_t: Optional[torch.Tensor],
                      gc_emb_d: Optional[torch.Tensor]):
    """Segments until at least ``n_samples`` codes are out, one stream
    (``last`` [1] int32) -> (codes [1, n_out] int32, all emitted: n_out
    may pass ``n_samples`` by up to k, and the states have consumed them;
    target state, draft state, next input [1], (n_segments,
    n_draft_accepted, n_out))."""
    c, dc = config, draft_config
    Q = c.quantization_channels
    inv_t = 1.0 / float(temperature)
    dev = last.device
    out: List[torch.Tensor] = []
    n_out = n_seg = n_acc = 0
    t_st, d_st = t_state, d_state
    with torch.no_grad():
        while n_out < n_samples:
            # 1. The draft proposes: k + 1 steps on a copy of its ring,
            #    consuming [last, c_0 .. c_{k-1}] (the last step's code is
            #    not needed), keeping each step's layer inputs.
            work = d_st._replace(layer_bufs=d_st.layer_bufs.clone())
            x = _featurize(last, dc)
            codes, pds, xs = [], [], []
            for j in range(k + 1):
                work, logits, ins = sampler_step(
                    draft_params, dc, work, x, gc_emb_d,
                    collect_layer_inputs=True)
                xs.append(ins)                                # [L, 1, R]
                if j == k:
                    break
                scaled = logits * inv_t                       # [1, Q]
                pds.append(torch.softmax(scaled, dim=-1)[0])
                code = torch.argmax(scaled + sample_gumbel(key, (1, Q)),
                                    dim=-1).to(torch.int32)
                codes.append(code)
                x = _featurize(code, dc)
            cs = torch.stack(codes, dim=1)                    # [1, k]
            pd = torch.stack(pds)                             # [k, Q]

            # 2. The target verifies the proposals and the bonus position
            #    in one pass.
            inputs = torch.cat([last[:, None], cs], dim=1)    # [1, k+1]
            logits_t, parts_t = _extend_forward(params, c, t_st, inputs,
                                                gc_emb_t)
            pt = torch.softmax(logits_t[0] * inv_t, dim=-1)   # [k+1, Q]

            # 3. Modified rejection sampling: accept c_j while
            #    u_j * pd(c_j) <= pt(c_j).
            cs0 = cs[0].long()
            j_ids = torch.arange(k, device=dev)
            u = torch.rand((k,), generator=key, device=dev)
            accept = u * pd[j_ids, cs0] <= pt[j_ids, cs0]
            m = int(torch.cumprod(accept.to(torch.int32), 0).sum())
            # The residual at the first rejected position; past the k
            # proposals (all accepted) the draft's probabilities are 0, so
            # the residual is p_target there.
            res = pt[m] - (pd[m] if m < k else 0.0)
            res = torch.clamp_min(res, 0.0)
            res_sum = res.sum()
            res = torch.where(res_sum > 1e-20, res / res_sum, pt[m])
            c_prime = torch.argmax(torch.log(res + 1e-30)
                                   + sample_gumbel(key, (Q,)))
            c_prime = c_prime.to(torch.int32)[None]           # [1]

            # 4. Both models commit m + 1 inputs: last and the m accepted
            #    proposals. The draft's window column j of layer l is the
            #    input of layer l at draft step j.
            v = m + 1
            t_st = _extend_commit(c, t_st, parts_t, v)
            full_in_d = torch.cat([d_st.causal_buf,
                                   _featurize(inputs, dc)], dim=1)
            win = torch.stack(xs, dim=0)                      # [k+1, L, 1, R]
            arrs_d = [torch.cat([_ordered_ring(d_st.layer_bufs, l, d,
                                               d_st.t).transpose(0, 1),
                                 win[:, l].transpose(0, 1)], dim=1)
                      for l, d in enumerate(dc.dilations)]
            d_st = _extend_commit(dc, d_st, (full_in_d, arrs_d), v)

            # 5. Emit the m accepted codes and the corrected/bonus code.
            out.append(torch.cat([cs[0, :m], c_prime]))
            last = c_prime
            n_out += v
            n_seg += 1
            n_acc += m
    codes = (torch.cat(out)[None] if out else
             torch.zeros((1, 0), dtype=torch.int32, device=dev))
    return codes, t_st, d_st, last, (n_seg, n_acc, n_out)


def generate_speculative(params: Params, config: WaveNetConfig,
                         draft_params: Params, draft_config: WaveNetConfig,
                         n_samples: int, key: torch.Generator, k: int = 8,
                         temperature: float = 1.0,
                         gc_ids: Optional[torch.Tensor] = None,
                         draft_gc_ids: Optional[torch.Tensor] = None,
                         seed_codes: Optional[torch.Tensor] = None,
                         batch_size: int = 1,
                         carry: Optional[SpeculativeCarry] = None,
                         return_carry: bool = False,
                         return_stats: bool = False):
    """``n_samples`` mu-law codes [B, n] by speculative sampling: the
    output is distributed exactly as the target model's.

    The draft is any WaveNet with the target's ``quantization_channels``;
    the speed-up is its acceptance rate. Both models are primed on the
    same seed (``seed_codes`` [B, T]: the first T-1 prime, the last is the
    first input; without it, receptive_field-1 silence codes and a random
    first code from ``key``) by the parallel prefill. Local conditioning
    is not supported (the loop carries no feature stream); LC models use
    ``sample.generate``. ``return_stats`` adds (n_segments,
    n_draft_accepted, n_emitted), summed over lanes: the mean accepted
    length is n_draft_accepted / n_segments (+1 emitted a segment).

    ``batch_size > 1`` (or a seed with B rows) runs B independent loops,
    lane i on ``lane_generators(key, B)[i]``. Resumable segments run at
    batch 1: ``return_carry=True`` returns every emitted code (up to k past
    ``n_samples``: the states have consumed them) and a
    ``SpeculativeCarry``; pass it back as ``carry`` to continue the stream.
    A continuation that keeps drawing from the same generator equals one
    run.
    """
    c, dc = config, draft_config
    check_models(c, dc)
    if seed_codes is None and carry is None:
        prime, first = unseeded_prime(c, batch_size, key)
        seed_codes = torch.cat([prime, first[:, None]], dim=1)
    B = batch_size if seed_codes is None else seed_codes.shape[0]
    if (carry is not None or return_carry) and (B != 1 or batch_size != 1):
        raise ValueError("resumable speculative decoding runs at batch "
                         "size 1 (acceptance makes emitted counts ragged "
                         "across lanes)")
    dev = key.device
    gc_emb_t = (embed_gc(params, c, torch.as_tensor(gc_ids, device=dev))
                if gc_ids is not None else None)
    gc_emb_d = (embed_gc(draft_params, dc,
                         torch.as_tensor(draft_gc_ids, device=dev))
                if draft_gc_ids is not None else None)

    def one(seed_row, lane_key, gce_t, gce_d):
        t_state = prefill_state(params, c, seed_row[:, :-1], gce_t)
        d_state = prefill_state(draft_params, dc, seed_row[:, :-1], gce_d)
        last = seed_row[:, -1].to(torch.int32)
        return _speculative_loop(params, c, draft_params, dc, t_state,
                                 d_state, last, lane_key, n_samples, k,
                                 temperature, gce_t, gce_d)

    if carry is not None:
        codes, t_st, d_st, last, stats = _speculative_loop(
            params, c, draft_params, dc, carry.t_state, carry.d_state,
            carry.last, key, n_samples, k, temperature, gc_emb_t, gc_emb_d)
    elif B == 1:
        codes, t_st, d_st, last, stats = one(seed_codes, key, gc_emb_t,
                                             gc_emb_d)
    else:
        rows, stats = [], (0, 0, 0)
        for i, lane_key in enumerate(lane_generators(key, B)):
            lane = one(seed_codes[i:i + 1], lane_key,
                       None if gc_emb_t is None else gc_emb_t[i:i + 1],
                       None if gc_emb_d is None else gc_emb_d[i:i + 1])
            rows.append(lane[0][:, :n_samples])
            stats = tuple(a + b for a, b in zip(stats, lane[4]))
        codes = torch.cat(rows, dim=0)

    if return_carry:
        out = (codes, SpeculativeCarry(t_state=t_st, d_state=d_st,
                                       last=last))
        return (*out, stats) if return_stats else out
    out = codes[:, :n_samples]
    return (out, stats) if return_stats else out
