"""Speculative decoding (port of ``polyaxon_tpu/serving/speculative.py``):
draft-model proposals verified by the target in one chunked forward,
lossless for greedy decoding (the output is the target's own greedy
sequence), with the target's sequential decode steps replaced by one
``decode_chunk`` per accepted run.

- The draft→verify→accept loop is a Python loop over rounds (the JAX
  package's ``lax.while_loop``); each round is one draft step per
  proposal plus one, and one verify chunk.
- Full-length caches (slot == position) make acceptance rollback-free:
  entries written for rejected candidates sit at positions the next
  round rewrites before anything attends them.
- Per-row positions and acceptance are vectors, so rows at different
  depths share each round.

The algorithm is the standard greedy speculative scheme (Leviathan et
al.; Chen et al.).
"""

from __future__ import annotations

import torch


def generate_speculative(cfg, params, draft_cfg, draft_params,
                         prompt: torch.Tensor, *, max_new_tokens: int,
                         k: int = 4, family=None, draft_family=None,
                         return_rounds: bool = False):
    """Greedy generation of ``max_new_tokens`` per row of prompt [B, P],
    draft-accelerated: [B, max_new_tokens], equal to
    ``family.generate(..., temperature=0)``. ``k`` = draft tokens per
    round; each round emits between 1 (no proposal accepted: the
    target's own token) and k+1 (all accepted plus the bonus).
    ``return_rounds`` also returns the number of verify rounds. Rows
    that finish early ride along until the deepest row is done."""
    from polyaxon_tpu_torch.models import llama

    family = family or llama
    draft_family = draft_family or llama
    B, P = prompt.shape
    dev = prompt.device
    max_new = int(max_new_tokens)
    # Full-length caches with verify headroom: positions reach at most
    # P + max_new + k.
    max_len = P + max_new + k + 1
    if max_len > cfg.max_seq_len or max_len > draft_cfg.max_seq_len:
        raise ValueError(
            f"prompt {P} + max_new {max_new} + draft window {k}+1 "
            f"exceeds max_seq_len (target {cfg.max_seq_len}, draft "
            f"{draft_cfg.max_seq_len})")

    logits_t, cache_t = family.prefill(cfg, params, prompt, max_len)
    t0 = logits_t.argmax(dim=-1)  # the token at position P
    _, cache_d = draft_family.prefill(draft_cfg, draft_params, prompt,
                                      max_len)

    rows = torch.arange(B, device=dev)
    width = max_new + k + 2  # + a trash column for masked writes
    trash = width - 1
    out = torch.zeros((B, width), dtype=torch.long, device=dev)
    out[:, 0] = t0
    n = torch.ones(B, dtype=torch.long, device=dev)  # t0 already emitted
    cur = t0
    pos = torch.full((B,), P, dtype=torch.long, device=dev)
    idx = torch.arange(k + 1, device=dev)[None, :]
    rounds = 0
    while bool((n < max_new).any()):
        live = n < max_new
        # k+1 draft steps for k proposals: the extra step writes the LAST
        # proposal's draft KV (position pos+k); without it a fully
        # accepted round leaves a zero-KV hole there that every later
        # draft query attends (lossless still, but acceptance collapses).
        tok, p, drafts = cur, pos, []
        for _ in range(k + 1):
            lg, cache_d = draft_family.decode_step_ragged(
                draft_cfg, draft_params, cache_d, tok, p)
            tok = lg.argmax(dim=-1)
            drafts.append(tok)
            p = p + 1
        d = torch.stack(drafts[:k], dim=1)  # [B, k] for pos+1..pos+k
        chunk = torch.cat([cur[:, None], d], dim=1)  # [B, k+1]
        logits, cache_t = family.decode_chunk(cfg, params, cache_t, chunk,
                                              pos)
        t = logits.argmax(dim=-1)  # [B, k+1]
        # Leading proposals the target agrees with, plus the target's own
        # token at the first disagreement (the bonus).
        a = torch.cumprod((d == t[:, :k]).long(), dim=1).sum(dim=1)
        emit = torch.minimum(a + 1, max_new - n)
        emit = torch.where(live, emit, torch.zeros_like(emit))
        col = torch.where(idx < emit[:, None], n[:, None] + idx,
                          torch.full_like(idx, trash))
        out[rows[:, None], col] = t
        cur = torch.where(live, t[rows, (emit - 1).clamp(min=0)], cur)
        n = n + emit
        pos = pos + emit
        rounds += 1
    if return_rounds:
        return out[:, :max_new], rounds
    return out[:, :max_new]


# --------------------------------------------------------------- policy
class LaneView:
    """What the speculation policy sees each decode-lane tick: queue +
    prefill-lane pressure, decode-lane headroom, and how long the
    oldest waiting request has been burning its TTFT budget. Built by
    the engine; plain data so the policy is testable alone."""

    __slots__ = ("prefill_backlog", "decode_free", "oldest_wait")

    def __init__(self, prefill_backlog: int = 0, decode_free: int = 0,
                 oldest_wait: float = 0.0):
        self.prefill_backlog = int(prefill_backlog)
        self.decode_free = int(decode_free)
        self.oldest_wait = float(oldest_wait)

    def __repr__(self):  # pragma: no cover - debug aid
        return (f"LaneView(prefill_backlog={self.prefill_backlog}, "
                f"decode_free={self.decode_free}, "
                f"oldest_wait={self.oldest_wait:.3f})")


class SpeculationPolicy:
    """Speculation as a scheduler output, not a static flag.

    Greedy speculative decoding is lossless for ANY draft length — the
    target verifies every proposal — so the policy is free to retune
    ``k`` per tick purely on throughput/latency grounds:

    state       | condition                                 | draft len
    ----------- | ----------------------------------------- | ---------
    speculate   | decode lane has idle headroom, no backlog  | k_max
    throttled   | prefill backlog > 0 or decode lane full    | k_max - backlog (>= k_min)
    off         | oldest wait > ttft_budget, or backlog >=   | 0
                | off_backlog (TTFT budget burning)          |

    Rationale: each extra draft token is speculative compute the decode
    tick must verify; under prefill pressure that compute competes with
    the chunk programs that bound TTFT, so the draft shrinks first and
    disappears entirely once the backlog is burning the TTFT budget.
    ``state`` after a ``draft_len`` call names the branch taken (the
    tests drive the machine through all three).
    """

    STATES = ("speculate", "throttled", "off")

    def __init__(self, k_max: int, *, k_min: int = 1, off_backlog: int = 4,
                 ttft_budget: float = 0.5):
        if k_max < 1:
            raise ValueError(f"k_max must be >= 1, got {k_max}")
        if not 1 <= k_min <= k_max:
            raise ValueError(
                f"need 1 <= k_min <= k_max, got k_min={k_min} "
                f"k_max={k_max}")
        if off_backlog < 1:
            raise ValueError(
                f"off_backlog must be >= 1, got {off_backlog}")
        if ttft_budget <= 0:
            raise ValueError(
                f"ttft_budget must be > 0, got {ttft_budget}")
        self.k_max = int(k_max)
        self.k_min = int(k_min)
        self.off_backlog = int(off_backlog)
        self.ttft_budget = float(ttft_budget)
        self.state = "speculate"

    def draft_len(self, view: LaneView) -> int:
        """Draft tokens the next decode tick should propose (0 = run a
        plain decode step)."""
        if (view.oldest_wait > self.ttft_budget
                or view.prefill_backlog >= self.off_backlog):
            self.state = "off"
            return 0
        if view.prefill_backlog > 0 or view.decode_free == 0:
            self.state = "throttled"
            return max(self.k_min, self.k_max - view.prefill_backlog)
        self.state = "speculate"
        return self.k_max
