"""Context-parallel attention for long sequences: ring + all-to-all.

Counterpart of ``tpu_operator/workloads/ringattention.py``. Long-context
workloads shard the *sequence* axis across cards; attention then needs
communication between cards because every query attends to every
(earlier) key. Both strategies run on every rank of a ``torch.distributed``
group, each rank holding its own sequence shard in [B, S_local, H, D]:

- **Ring attention** (``ring_attention``): K/V blocks travel around the
  ring of ranks (rank r sends to r+1 and receives from r-1, one batched
  P2P exchange per hop) while each rank's Q stays put; partial results
  merge with an online softmax (running max + normaliser), so the result
  is exact. Differentiable through ``parallel.comm.RingShift``, whose
  backward sends the cotangent the other way round the ring.
- **Ulysses / all-to-all** (``ulysses_attention``): ``all_to_all_single``
  re-shards [B, S/n, H, D] -> [B, S, H/n, D], runs plain attention over
  the full sequence with a head subset, then re-shards back. It needs
  n_heads % n == 0.

``run()`` spawns one rank per card (NCCL) or on the CPU (gloo) and holds
the result to the single-device oracle, ``reference_attention``.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

from ..parallel import comm, mesh
from .backend import resolve_device, synchronize
from .flashattention import (NEG_INF, flash_attention_blocks,
                             flash_attention_blocks_reference)

# the oracle materialises [B, H, S, S] f32 scores up to this size; past it
# the plain chunked flash version is the oracle
REFERENCE_SCORE_BYTES = 2 << 30


def reference_attention(q, k, v, causal: bool = True):
    """Plain single-device attention, the correctness oracle.
    q,k,v: [B, S, H, D] -> [B, S, H, D]."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        S = q.shape[1]
        mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores.float(), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(q.dtype), v)


def _block_attend(q, k, v, q_offset: int, k_offset: int, causal: bool):
    """One (Q-block, KV-block) tile: returns (out, row max m, normaliser l)
    with scores kept in f32 for the online-softmax merge.
    q: [B, Sq, H, D]; k,v: [B, Sk, H, D]."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if causal:
        q_pos = q_offset + torch.arange(q.shape[1], device=q.device)
        k_pos = k_offset + torch.arange(k.shape[1], device=q.device)
        scores = torch.where(q_pos[:, None] >= k_pos[None, :], scores,
                             NEG_INF)
    m = scores.amax(dim=-1)                           # [B, H, Sq]
    p = torch.exp(scores - m[..., None])
    # fully-masked rows: m == NEG_INF, p == 1 from exp(0); zero them
    p = torch.where(m[..., None] <= NEG_INF / 2, 0.0, p)
    l = p.sum(dim=-1)                                 # [B, H, Sq]
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)
    return out.float(), m, l


def _block_attend_flash(q, k, v, q_offset: int, k_offset: int,
                        causal: bool):
    """Same contract as ``_block_attend``, but the tile runs as kernel B2
    (``workloads/flashattention.py``): scores never leave the chip and the
    kernel's (m, l) statistics feed the ring merge directly."""
    B, S, H, D = q.shape
    fold = lambda t: t.transpose(1, 2).reshape(B * H, -1, D)
    out, m, l = flash_attention_blocks(fold(q), fold(k), fold(v),
                                       q_offset, k_offset, causal=causal)
    unnorm = out.float() * l[..., None]
    unnorm = unnorm.reshape(B, H, S, D).transpose(1, 2)
    return unnorm, m.reshape(B, H, S), l.reshape(B, H, S)


def merge(o, l, m, bo, bm, bl):
    """Fold a block's (out, m, l) into the running (o, l, m), rescaling
    both onto the new max."""
    m_new = torch.maximum(m, bm)
    dead = m_new <= NEG_INF / 2
    alpha = torch.where(dead, 0.0, torch.exp(m - m_new))   # old-state scale
    beta = torch.where(dead, 0.0, torch.exp(bm - m_new))   # block scale
    l = l * alpha + bl * beta
    o = o * alpha.transpose(1, 2)[..., None] \
        + bo * beta.transpose(1, 2)[..., None]
    return o, l, m_new


class _ForwardOnly(torch.autograd.Function):
    """Passes ``out`` through and refuses a gradient: kernel B2 has no
    backward, as the Pallas kernel defines no VJP."""

    @staticmethod
    def forward(ctx, out, *inputs):
        return out.clone()

    @staticmethod
    def backward(ctx, grad):
        raise RuntimeError(
            "ring_attention(use_flash=True) is forward-only: kernel B2 has "
            "no backward; use use_flash=False (the einsum ring) to train")


def _ring_attention_local(q, k, v, group, causal: bool, use_flash: bool):
    n, idx = dist.get_world_size(group), dist.get_rank(group)
    B, s_local, H, _ = q.shape
    q_offset = idx * s_local
    o = torch.zeros_like(q, dtype=torch.float32)
    l = torch.zeros((B, H, s_local), dtype=torch.float32, device=q.device)
    m = l + NEG_INF
    block_attend = _block_attend_flash if use_flash else _block_attend

    def attend(i, o, l, m, k_blk, v_blk):
        # after i hops, the resident K/V block came from rank (idx - i) % n
        k_offset = ((idx - i) % n) * s_local
        bo, bm, bl = block_attend(q, k_blk, v_blk, q_offset, k_offset, causal)
        return merge(o, l, m, bo, bm, bl)

    # n-1 hops: the final resident block is attended after the loop, so
    # its K/V are never shipped a pointless extra hop round the ring
    k_blk, v_blk = k, v
    for i in range(n - 1):
        o, l, m = attend(i, o, l, m, k_blk, v_blk)
        k_blk, v_blk = comm.RingShift.apply(group, k_blk, v_blk)
    o, l, _ = attend(n - 1, o, l, m, k_blk, v_blk)
    l = torch.where(l == 0.0, 1.0, l)  # fully-masked rows output zeros
    return (o / l.transpose(1, 2)[..., None]).to(q.dtype)


def ring_attention(q, k, v, group=None, causal: bool = True,
                   use_flash: bool = False):
    """Exact attention with the sequence axis sharded over ``group`` (the
    default group when None); call on every rank with its shard.
    q,k,v: [B, S_local, H, D], rank r holding positions
    [r*S_local, (r+1)*S_local).

    ``use_flash`` runs each hop's local tile as kernel B2 (forward and
    inference path; a gradient raises); the default einsum tile is
    differentiable and is what training uses."""
    if not use_flash:
        return _ring_attention_local(q, k, v, group, causal, False)
    with torch.no_grad():
        out = _ring_attention_local(q, k, v, group, causal, True)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        out = _ForwardOnly.apply(out, q, k, v)
    return out


def ulysses_attention(q, k, v, group=None, causal: bool = True):
    """All-to-all sequence parallelism (Ulysses) over ``group``; call on
    every rank with its [B, S_local, H, D] shard. Needs n_heads % n == 0.
    Differentiable (the all-to-all's backward is the reverse all-to-all)."""
    n = dist.get_world_size(group)
    B, s_local, H, D = q.shape
    if H % n:
        raise ValueError(f"n_heads={H} not divisible by axis size {n}")
    hl = H // n

    def to_sequence(t):  # [B, S_local, H, D] -> [B, S, H/n, D]
        # heads lead, so rank j's block of dim 0 is head group j
        y = comm.all_to_all(t.permute(2, 0, 1, 3), group)
        # block i came from rank i: its sequence shard of this rank's heads
        return y.reshape(n, hl, B, s_local, D).permute(2, 0, 3, 1, 4) \
            .reshape(B, n * s_local, hl, D)

    def to_heads(t):     # [B, S, H/n, D] -> [B, S_local, H, D]
        x = t.reshape(B, n, s_local, hl, D).permute(1, 3, 0, 2, 4)
        y = comm.all_to_all(x.reshape(H, B, s_local, D), group)
        # block j came from rank j: this rank's shard of head group j
        return y.permute(1, 2, 0, 3)

    out = reference_attention(to_sequence(q), to_sequence(k), to_sequence(v),
                              causal=causal)
    return to_heads(out)


# ---------------------------------------------------------------------------
# harness
# ---------------------------------------------------------------------------


@dataclass
class ContextParallelResult:
    strategy: str
    devices: int
    seq_len: int
    max_abs_err: float
    seconds: float
    correct: bool


class CaseReport(NamedTuple):
    """One case on one rank: the harness's result, kernel B2's launches by
    this rank's two calls, and the worst per-row relative error of the
    gathered output (``row_rel_err``; nan off rank 0)."""
    result: ContextParallelResult
    launches: int
    row_rel_err: float


def row_rel_err(got, want) -> float:
    """max over rows (every index but the last) of ||got - want|| /
    ||want||; 0 where both rows vanish. Rounding noise stays a fixed share
    of each row however small its values, where a dropped or misplaced K/V
    chunk is a share of about sqrt(D / keys seen)."""
    got, want = got.float(), want.float()
    err = (got - want).norm(dim=-1)
    return (err / want.norm(dim=-1).clamp_min(1e-30)).max().item()


def oracle(q, k, v, causal: bool):
    """``reference_attention``, or past ``REFERENCE_SCORE_BYTES`` of scores
    the plain chunked flash version on the whole sequence."""
    B, S, H, D = q.shape
    if B * H * S * S * 4 <= REFERENCE_SCORE_BYTES:
        return reference_attention(q, k, v, causal=causal)
    fold = lambda t: t.transpose(1, 2).reshape(B * H, S, D)
    out, _, _ = flash_attention_blocks_reference(
        fold(q), fold(k), fold(v), 0, 0, causal=causal, q_tile=S)
    return out.reshape(B, H, S, D).transpose(1, 2)


def context_parallel_case(device, strategy: str, seq_len: int,
                          n_heads: int, head_dim: int, batch: int,
                          causal: bool = True,
                          use_flash: bool = False) -> CaseReport:
    """One case on this rank of the current group: seeded inputs (the same
    on every rank; each takes its shard), one warm-up call, one timed
    call; rank 0 gathers the output and holds it to the oracle (other
    ranks report nan errors)."""
    n, rank = dist.get_world_size(), dist.get_rank()
    if seq_len % n:
        raise ValueError(f"seq_len={seq_len} not divisible by {n} ranks")
    if strategy not in ("ring", "ulysses"):
        raise ValueError(f"unknown strategy {strategy!r}")
    dtype = torch.float32 if device.type == "cpu" else torch.bfloat16
    gen = torch.Generator(device=device).manual_seed(0)
    shape = (batch, seq_len, n_heads, head_dim)
    q, k, v = (torch.randn(shape, generator=gen, device=device).to(dtype)
               for _ in range(3))
    s_local = seq_len // n
    qs, ks, vs = (t[:, rank * s_local:(rank + 1) * s_local].contiguous()
                  for t in (q, k, v))

    def call():
        with torch.no_grad():
            if strategy == "ring":
                return ring_attention(qs, ks, vs, causal=causal,
                                      use_flash=use_flash)
            return ulysses_attention(qs, ks, vs, causal=causal)

    launches = flash_attention_blocks.launches
    out = call()
    synchronize(device)
    dist.barrier()
    t0 = time.perf_counter()
    out = call()
    synchronize(device)
    seconds = time.perf_counter() - t0
    launches = flash_attention_blocks.launches - launches

    parts = [torch.empty_like(out) for _ in range(n)]
    dist.all_gather(parts, out.contiguous())
    err = rel = float("nan")
    if rank == 0:
        with torch.no_grad():
            want = oracle(q, k, v, causal)
        got = torch.cat(parts, dim=1)
        err = (got.float() - want.float()).abs().max().item()
        rel = row_rel_err(got, want)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    result = ContextParallelResult(strategy=strategy, devices=n,
                                   seq_len=seq_len, max_abs_err=err,
                                   seconds=seconds, correct=err < tol)
    return CaseReport(result, launches, rel)


def context_parallel_rank(rank, world_size, device,
                          cases: Sequence[dict]) -> List[CaseReport]:
    """Per-rank body for ``mesh.spawn``: ``context_parallel_case`` for each
    keyword dict of ``cases``, in order."""
    return [context_parallel_case(device, **case) for case in cases]


def run(seq_len: int = 2048, n_heads: int = 8, head_dim: int = 64,
        batch: int = 1, causal: bool = True, strategy: str = "ring",
        device=None, world_size: Optional[int] = None
        ) -> ContextParallelResult:
    """Run context-parallel attention over ``world_size`` ranks (default:
    every visible card over NCCL; ``device="cpu"`` runs gloo, one rank
    unless asked) and check it against the single-device oracle, in f32
    on the CPU and bf16 on the card."""
    dev_type = resolve_device(device).type
    if world_size is None:
        world_size = torch.cuda.device_count() if dev_type == "cuda" else 1
    if seq_len % world_size:
        raise ValueError(f"seq_len={seq_len} not divisible by {world_size} "
                         f"ranks")
    case = dict(strategy=strategy, seq_len=seq_len, n_heads=n_heads,
                head_dim=head_dim, batch=batch, causal=causal)
    ranks = mesh.spawn(context_parallel_rank, world_size, dev_type,
                       args=([case],))
    return ranks[0][0].result


def main() -> int:
    import json

    results = [run(strategy=s).__dict__ for s in ("ring", "ulysses")]
    print(json.dumps(results))
    return 0 if all(r["correct"] for r in results) else 1


if __name__ == "__main__":
    raise SystemExit(main())
