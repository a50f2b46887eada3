"""Token-bucket rate limiting (reference: src/emqx_limiter.erl via
esockd_rate_limit): connection msgs-in, bytes-in, publish quota."""

from __future__ import annotations

import time


class TokenBucket:
    def __init__(self, rate: float, burst: float) -> None:
        self.rate = float(rate)       # tokens per second
        self.burst = float(burst)     # bucket capacity
        self.tokens = float(burst)
        self.ts = time.monotonic()

    def consume(self, n: float = 1.0) -> float:
        """Take n tokens; returns seconds to pause (0 = no limit hit)."""
        now = time.monotonic()
        self.tokens = min(self.burst, self.tokens + (now - self.ts) * self.rate)
        self.ts = now
        self.tokens -= n
        if self.tokens >= 0:
            return 0.0
        return -self.tokens / self.rate

    def check(self, n: float = 1.0) -> bool:
        """Non-consuming peek: would n tokens be available?"""
        now = time.monotonic()
        avail = min(self.burst, self.tokens + (now - self.ts) * self.rate)
        return avail >= n
