"""Condition encoding and the preprocessing cache (paper §2.2) — the port of
``repro.core.preprocess``.

``FrozenTextEncoder`` is the reference's text-tower stand-in: prompts are
tokenised by word hashing (the same ids as the reference), embedded through
a frozen table and run through frozen ``tanh`` projections.  Its weights are
drawn from a ``torch.Generator`` seeded with ``seed``, or carried over from
the JAX package's encoder with ``weights=`` (numpy arrays, as
``models.params.from_numpy`` takes them).

``PreprocessCache`` reads and writes the reference's on-disk format: one
``<sha1(prompt)[:24]>.npz.zst`` blob per prompt holding ``cond`` and
``pooled`` arrays, zstd-compressed when the ``zstandard`` module is present
and raw npz otherwise (reads detect the frame), so conditions either package
encoded feed the other unchanged.  ``ConditionProvider`` serves the live path
(every request re-encoded) or, with ``preprocessing=True``, the cache alone:
the encoder is then never built, and a miss raises unless
``encode_on_miss``.
"""
from __future__ import annotations

import hashlib
import io
import math
import os
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

try:
    import zstandard
except ImportError:                      # pragma: no cover - env dependent
    zstandard = None                     # raw npz blobs instead

from repro_torch.device import resolve_device
from repro_torch.models.params import from_numpy

F32 = torch.float32

# zstd frame magic: tells a compressed blob from a raw npz one
_ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"


def prompt_key(prompt: str) -> str:
    return hashlib.sha1(prompt.encode()).hexdigest()[:24]


class FrozenTextEncoder:
    """Frozen condition encoder (text-tower stand-in), on ``device``.

    ``weights``: optional ``{"embed": (vocab, hidden), "layers": {"0": (hidden,
    hidden), ...}, "w_out": (hidden, cond_dim)}`` of numpy arrays (the JAX
    encoder's ``embed``, ``layers`` and ``w_out``) to use instead of a fresh
    draw."""

    def __init__(self, cond_dim: int = 512, cond_len: int = 16,
                 vocab: int = 32768, hidden: int = 2048, depth: int = 2,
                 seed: int = 3, *, device=None,
                 weights: Optional[Dict] = None):
        self.cond_dim, self.cond_len = cond_dim, cond_len
        self.vocab, self.hidden, self.depth = vocab, hidden, depth
        self.device = resolve_device(device)
        if weights is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)

            def draw(shape, scale):
                return torch.randn(shape, generator=gen, dtype=F32,
                                   device=self.device).mul_(scale)

            self.embed = draw((vocab, hidden), 0.02)
            self.layers = [draw((hidden, hidden), 1.0 / math.sqrt(hidden))
                           for _ in range(depth)]
            self.w_out = draw((hidden, cond_dim), 1.0 / math.sqrt(hidden))
        else:
            w = from_numpy(weights, self.device, F32)
            self.embed, self.w_out = w["embed"], w["w_out"]
            self.layers = [w["layers"][k]
                           for k in sorted(w["layers"], key=int)]
            if (tuple(self.embed.shape) != (vocab, hidden)
                    or tuple(self.w_out.shape) != (hidden, cond_dim)
                    or len(self.layers) != depth):
                raise ValueError("encoder weights do not fit "
                                 f"vocab={vocab} hidden={hidden} "
                                 f"depth={depth} cond_dim={cond_dim}")

    @property
    def n_params(self) -> int:
        return int(self.embed.numel() + sum(w.numel() for w in self.layers)
                   + self.w_out.numel())

    def tokenize(self, prompt: str) -> np.ndarray:
        words = (prompt.lower().split() + ["<pad>"] * self.cond_len)
        ids = [int(hashlib.sha1(w.encode()).hexdigest()[:8], 16) % self.vocab
               for w in words[:self.cond_len]]
        return np.asarray(ids, np.int64)

    @torch.no_grad()
    def encode(self, prompts: Sequence[str]) -> Dict[str, torch.Tensor]:
        """{"cond": (N, cond_len, cond_dim), "pooled": (N, cond_dim)}, f32 on
        the encoder's device."""
        ids = torch.from_numpy(np.stack([self.tokenize(p) for p in prompts]))
        h = self.embed[ids.to(self.device)]               # (N, L, hidden)
        for w in self.layers:
            h = torch.tanh(h @ w)
        emb = h @ self.w_out                               # (N, L, cond_dim)
        return {"cond": emb, "pooled": emb.mean(dim=1)}


class PreprocessCache:
    """zstd-compressed npz cache of condition embeddings, one blob per
    prompt, in the reference's format."""

    def __init__(self, cache_dir: str):
        self.dir = cache_dir
        os.makedirs(cache_dir, exist_ok=True)
        self._cctx = zstandard.ZstdCompressor(level=3) if zstandard else None
        self._dctx = zstandard.ZstdDecompressor() if zstandard else None

    def _path(self, prompt: str) -> str:
        return os.path.join(self.dir, prompt_key(prompt) + ".npz.zst")

    def has(self, prompt: str) -> bool:
        return os.path.exists(self._path(prompt))

    def put(self, prompt: str, arrays: Dict[str, np.ndarray]) -> None:
        buf = io.BytesIO()
        np.savez(buf, **{k: np.asarray(v) for k, v in arrays.items()})
        payload = buf.getvalue()
        if self._cctx is not None:
            payload = self._cctx.compress(payload)
        with open(self._path(prompt), "wb") as f:
            f.write(payload)

    def get(self, prompt: str) -> Dict[str, np.ndarray]:
        with open(self._path(prompt), "rb") as f:
            raw = f.read()
        if raw[:4] == _ZSTD_MAGIC:
            if self._dctx is None:
                raise RuntimeError(
                    "cache entry is zstd-compressed but the 'zstandard' "
                    "module is not installed; re-run preprocessing")
            raw = self._dctx.decompress(raw)
        with np.load(io.BytesIO(raw)) as z:
            return {k: z[k] for k in z.files}


def preprocess_dataset(prompts: Sequence[str], cache: PreprocessCache,
                       encoder: Optional[FrozenTextEncoder] = None,
                       batch: int = 64, device="cpu", **enc_kw) -> int:
    """Phase 1: encode and cache every prompt not cached yet.  Returns the
    number newly cached.  The encoder (built on ``device`` if not given) is
    only built when something is missing."""
    todo = [p for p in prompts if not cache.has(p)]
    if todo and encoder is None:
        encoder = FrozenTextEncoder(**enc_kw, device=device)
    n = 0
    for i in range(0, len(todo), batch):
        chunk = todo[i:i + batch]
        out = encoder.encode(chunk)
        cond = out["cond"].cpu().numpy()
        pooled = out["pooled"].cpu().numpy()
        for j, p in enumerate(chunk):
            cache.put(p, {"cond": cond[j], "pooled": pooled[j]})
            n += 1
    return n


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``.  To a CUDA device through pinned memory
    and a non-blocking copy, which waits for no device work: a pipelined
    loop fetches the next conditions while a step is in flight."""
    t = torch.from_numpy(a)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


class ConditionProvider:
    """Training- and serving-phase condition source, on ``device``.

    ``preprocessing=True``  -> reads the cache; the encoder is never built
                               (``encoder_resident`` stays False) unless
                               ``encode_on_miss=True`` lets a miss encode
                               (and cache) the prompt; otherwise a miss
                               raises :class:`KeyError` naming it.
    ``preprocessing=False`` -> re-encodes every request through a resident
                               encoder.

    ``prefetch(prompts)`` warms a future ``get(prompts)`` on one background
    worker (cache IO and stacking); ``get`` consumes a matching prefetch or
    computes now, on the same worker once it exists, so the encoder and the
    cache are never driven from two threads at once.
    """

    def __init__(self, *, preprocessing: bool = False,
                 cache: Optional[PreprocessCache] = None,
                 encoder_kw: Optional[dict] = None,
                 encode_on_miss: bool = False, device=None):
        if preprocessing and cache is None:
            raise ValueError("preprocessing=True needs a PreprocessCache")
        self.preprocessing = preprocessing
        self.cache = cache
        self.encode_on_miss = encode_on_miss
        self.device = resolve_device(device)
        self._encoder: Optional[FrozenTextEncoder] = None
        self._encoder_kw = dict(encoder_kw or {})
        self._executor: Optional[ThreadPoolExecutor] = None
        self._pending: Optional[Tuple[Tuple[str, ...], Future]] = None

    @property
    def encoder_resident(self) -> bool:
        return self._encoder is not None

    @property
    def resident_param_bytes(self) -> int:
        return (self._encoder.n_params * 4) if self._encoder else 0

    def _ensure_encoder(self) -> FrozenTextEncoder:
        if self._encoder is None:
            self._encoder = FrozenTextEncoder(**self._encoder_kw,
                                              device=self.device)
        return self._encoder

    def _cached(self, prompt: str) -> Dict[str, np.ndarray]:
        try:
            return self.cache.get(prompt)
        except FileNotFoundError:
            if not self.encode_on_miss:
                raise KeyError(
                    f"prompt not in preprocessing cache "
                    f"({self.cache.dir!r}): {prompt!r} — run "
                    "preprocess_dataset() over the corpus first, or opt in "
                    "with ConditionProvider(..., encode_on_miss=True)"
                ) from None
            out = self._ensure_encoder().encode([prompt])
            rec = {"cond": out["cond"][0].cpu().numpy(),
                   "pooled": out["pooled"][0].cpu().numpy()}
            self.cache.put(prompt, rec)
            return rec

    def _get_now(self, prompts: Sequence[str]) -> Dict[str, torch.Tensor]:
        if self.preprocessing:
            arrs = [self._cached(p) for p in prompts]
            return {k: _to_device(np.stack([a[k] for a in arrs]), self.device)
                    for k in ("cond", "pooled")}
        return self._ensure_encoder().encode(prompts)

    def prefetch(self, prompts: Sequence[str]) -> None:
        """Warm ``get(prompts)`` on the background worker (a newer prefetch
        supersedes an unconsumed older one); errors surface at ``get``."""
        key = tuple(prompts)
        if self._pending is not None and self._pending[0] == key:
            return
        if self._executor is None:
            self._executor = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="cond-prefetch")
        self._pending = (key, self._executor.submit(self._get_now,
                                                    list(prompts)))

    def get(self, prompts: Sequence[str]) -> Dict[str, torch.Tensor]:
        pending, self._pending = self._pending, None
        if pending is not None and pending[0] == tuple(prompts):
            return pending[1].result()
        if self._executor is not None:
            return self._executor.submit(self._get_now,
                                         list(prompts)).result()
        return self._get_now(prompts)
