"""Shape-bucket policy for the serving engine — a copy of
``repro.serving.buckets`` (pure Python).

The engine admits requests into a small fixed grid of batch tiers
(default: powers of two up to ``max_batch``) and pads partial batches up to
the smallest covering tier.  In the JAX package that bounds jit
recompiles; in the port, which runs eagerly, it bounds the set of shapes
the kernels and cuBLAS see, so ``warmup()`` can touch every one of them
before traffic arrives.  Padded lanes are free under the per-request-seeded
rollout: real lanes do not depend on who pads the batch.

``dp`` rounds every tier up to a multiple of a data-parallel device count;
the port serves on one device, so it stays 1.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple


def default_buckets(max_batch: int) -> Tuple[int, ...]:
    """Powers of two up to and including ``max_batch`` (the tier ladder a
    mixed request load actually exercises: full buckets ride the top tier,
    deadline-flushed remainders the small ones)."""
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    tiers = []
    b = 1
    while b < max_batch:
        tiers.append(b)
        b *= 2
    tiers.append(max_batch)
    return tuple(tiers)


class BucketGrid:
    """The (batch,) tier ladder, optionally dp-aligned.

    ``pick(n)`` returns the smallest tier >= n; callers never dispatch more
    than ``capacity`` (= the largest tier) requests per batch.
    """

    def __init__(self, buckets: Optional[Sequence[int]] = None, *,
                 max_batch: int = 8, dp: int = 1):
        if dp < 1:
            raise ValueError(f"dp must be >= 1, got {dp}")
        if buckets:
            raw = tuple(buckets)
            over = [b for b in raw if b > max_batch]
            if over:
                raise ValueError(
                    f"bucket sizes {over} exceed max_batch={max_batch} "
                    "(the memory cap) — raise max_batch or shrink the "
                    "tiers")
        else:
            raw = default_buckets(max_batch)
        if any(b < 1 for b in raw):
            raise ValueError(f"bucket sizes must be >= 1, got {raw}")
        # dp-align each tier, then dedupe (1 and 2 both round to 4 on dp=4)
        aligned = sorted({-(-b // dp) * dp for b in raw})
        # alignment must not raise the max_batch memory cap: clamp the
        # ladder to the largest dp multiple <= max_batch (dp itself when
        # the cap is below one per-device lane each — the smallest batch
        # a mesh can serve at all)
        cap = max(dp, (max_batch // dp) * dp)
        self.dp = dp
        self.sizes: Tuple[int, ...] = (tuple(b for b in aligned if b <= cap)
                                       or (cap,))

    @property
    def capacity(self) -> int:
        return self.sizes[-1]

    def pick(self, n: int) -> int:
        """Smallest tier covering ``n`` requests (n <= capacity)."""
        if n < 1:
            raise ValueError(f"cannot bucket {n} requests")
        for b in self.sizes:
            if b >= n:
                return b
        raise ValueError(
            f"{n} requests exceed the largest bucket ({self.capacity}); "
            "dispatch in capacity-sized slices")

    def __repr__(self) -> str:
        return f"BucketGrid(sizes={self.sizes}, dp={self.dp})"


class StepGrid:
    """The admitted ``num_steps`` quality tiers — the second axis of the
    compile grid.

    The batch ladder bounds one shape axis; this bounds the other: a
    request may only ask for a ``num_steps`` value in the tier grid
    (e.g. a cheap 4-step draft tier next to the full-quality tier), and
    ``warmup()`` pre-traces every (bucket × step tier) pair.  Together
    they make "steady state never compiles" *provable*: every admitted
    request lands on a warmed shape, instead of one odd ``num_steps=7``
    submit silently compiling a fresh executable on the hot path.
    """

    def __init__(self, tiers: Optional[Sequence[int]] = None, *,
                 default: int):
        if default < 1:
            raise ValueError(f"num_steps must be >= 1, got {default}")
        raw = tuple(tiers) if tiers else ()
        if any(s < 1 for s in raw):
            raise ValueError(f"step tiers must be >= 1, got {raw}")
        self.default = default
        self.sizes: Tuple[int, ...] = tuple(sorted(set(raw) | {default}))

    def resolve(self, num_steps: Optional[int]) -> int:
        """Default tier for ``None``; otherwise admit only grid members —
        an off-grid value would compile on the hot path."""
        if num_steps is None:
            return self.default
        if num_steps not in self.sizes:
            raise ValueError(
                f"num_steps={num_steps} is outside the warmed step-tier "
                f"grid {self.sizes} — off-grid values would compile on "
                "the hot path; pass step_tiers= at engine construction "
                "to widen the grid")
        return num_steps

    def __repr__(self) -> str:
        return f"StepGrid(sizes={self.sizes}, default={self.default})"
