"""Logging + resilience primitives (reference common/utils.py:15-197).

`Timer.elapsed_ms` is a *property* here — the reference defined it as a method
but called it as a property everywhere (SURVEY.md §2.9 #17); we implement what
the callers meant.
"""
from __future__ import annotations

import json
import logging
import threading
import time
from typing import Any, Callable, Optional

_CONFIGURED = False


def setup_logging(level: str = "INFO") -> None:
    """Root logging config (the reference imported a `setup_logging` that did
    not exist — collision_system.py:12; here it does)."""
    global _CONFIGURED
    logging.basicConfig(
        level=getattr(logging, level.upper(), logging.INFO),
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    _CONFIGURED = True


def get_logger(name: str) -> logging.Logger:
    if not _CONFIGURED:
        setup_logging()
    return logging.getLogger(name)


def to_json(obj: Any) -> str:
    return json.dumps(obj, default=str)


def from_json(s: str) -> Any:
    return json.loads(s)


class Timer:
    """Context-manager stopwatch. Reference: utils.py:32-58."""

    def __init__(self):
        self.start_time: Optional[float] = None
        self.end_time: Optional[float] = None

    def __enter__(self) -> "Timer":
        self.start_time = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.end_time = time.perf_counter()

    @property
    def elapsed_s(self) -> float:
        if self.start_time is None:
            return 0.0
        end = self.end_time if self.end_time is not None else time.perf_counter()
        return end - self.start_time

    @property
    def elapsed_ms(self) -> float:
        return self.elapsed_s * 1000.0


class RateLimiter:
    """Token-bucket limiter. Reference: utils.py:60-119."""

    def __init__(self, rate: float, capacity: Optional[float] = None):
        self.rate = float(rate)
        self.capacity = float(capacity if capacity is not None else rate)
        self._tokens = self.capacity
        self._last = time.monotonic()
        self._lock = threading.Lock()

    def _refill(self) -> None:
        now = time.monotonic()
        self._tokens = min(self.capacity,
                           self._tokens + (now - self._last) * self.rate)
        self._last = now

    def allow(self, tokens: float = 1.0) -> bool:
        with self._lock:
            self._refill()
            if self._tokens >= tokens:
                self._tokens -= tokens
                return True
            return False

    def set_rate(self, rate: float) -> None:
        with self._lock:
            self._refill()
            self.rate = float(rate)
            self.capacity = max(self.capacity, self.rate)


class CircuitBreaker:
    """CLOSED -> OPEN -> HALF_OPEN breaker. Reference: utils.py:121-197."""

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(self, failure_threshold: int = 5, recovery_timeout: float = 30.0,
                 half_open_max_calls: int = 1):
        self.failure_threshold = failure_threshold
        self.recovery_timeout = recovery_timeout
        self.half_open_max_calls = half_open_max_calls
        self.state = self.CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._half_open_calls = 0
        self._lock = threading.Lock()

    def allow(self) -> bool:
        with self._lock:
            if self.state == self.CLOSED:
                return True
            if self.state == self.OPEN:
                if time.monotonic() - self._opened_at >= self.recovery_timeout:
                    self.state = self.HALF_OPEN
                    self._half_open_calls = 0
                else:
                    return False
            if self._half_open_calls < self.half_open_max_calls:
                self._half_open_calls += 1
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            self.state = self.CLOSED

    def record_failure(self) -> None:
        with self._lock:
            self._failures += 1
            if self.state == self.HALF_OPEN or self._failures >= self.failure_threshold:
                self.state = self.OPEN
                self._opened_at = time.monotonic()

    def call(self, fn: Callable, *args, **kw) -> Any:
        if not self.allow():
            raise RuntimeError("circuit breaker open")
        try:
            out = fn(*args, **kw)
        except Exception:
            self.record_failure()
            raise
        self.record_success()
        return out


def compile_cache_dir() -> str:
    """Where the persistent compile cache lives: $JAX_COMPILATION_CACHE_DIR
    when set, else a fixed directory inside the checkout (`.jax_cache/`,
    git-ignored). A fixed path matters: the path is part of the cache key,
    so a directory that moves never hits."""
    import os

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(repo, ".jax_cache")


def enable_compile_cache() -> None:
    """Persistent JAX compilation cache, so reruns skip the multi-second
    compiles of the large-fleet programs (compile_cache_dir says where)."""
    import jax

    jax.config.update("jax_compilation_cache_dir", compile_cache_dir())
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)
