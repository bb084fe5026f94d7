"""The post-decode stage: VAE image decode and optional CLIP scoring.

Port of ``dalle_pytorch_tpu/serve/postprocess.py`` (``PostProcessor``,
``:30-199``): the engine hands each finished request here (its
``complete`` hook), and its image tokens are decoded through the VAE
with DALLE's tied codebook (``generate_images``' ``vae.decode(img_seq,
codebook=image_emb)``); with a ``clip`` model the image is scored
against the request's completed text span (``models/clip.py::
clip_apply``, whose sparse layers run kernel K3 without the causal
constraint under ``sparse_impl='pallas'``) into ``Result.clip_score``.

Two ways to run it. ``start()`` runs a worker thread: ``submit`` (the
engine's hook) queues the request and returns, so image decoding
overlaps token decoding, and ``close()`` drains the queue before it
returns. Called directly (``post(handle, result)``) the stage runs in
the caller's thread. Either way a failure fulfils the handle with
``status='error'``; no handle is dropped. Previews come with the HTTP
server's slice.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Optional

import numpy as np
import torch

from dalle_pytorch_tpu_torch.models import clip as clip_mod
from dalle_pytorch_tpu_torch.models import dalle as D
from dalle_pytorch_tpu_torch.models import vae as vae_mod
from dalle_pytorch_tpu_torch.serve import scheduler as S


class PostProcessor:
    """The stage between the engine and the caller: decode, attach the
    (H, W, C) float32 image (and the CLIP score) to the result, fulfil
    the handle."""

    def __init__(self, vae: vae_mod.VAEDecoder, dalle: D.DALLE, *,
                 clip: Optional[clip_mod.CLIP] = None,
                 max_pending: int = 64):
        self.vae = vae
        self.dalle = dalle
        self.clip = clip
        self.decoded = 0
        # bounded: a stalled consumer holds the engine at submit() instead
        # of growing an unbounded backlog
        self._q: queue.Queue = queue.Queue(maxsize=max_pending)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "PostProcessor":
        self._thread = threading.Thread(target=self._work, daemon=True,
                                        name="serve-postprocess")
        self._thread.start()
        return self

    def close(self, timeout: float = 30.0) -> None:
        """Stop the worker once the queue is drained."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)

    def submit(self, handle: S.RequestHandle, result: S.Result) -> None:
        """The engine's ``complete`` hook when the worker runs."""
        self._q.put((handle, result))

    def pending(self) -> int:
        return self._q.qsize()

    # -- the stage ------------------------------------------------------------

    def _img_batch(self, tokens) -> torch.Tensor:
        """One [1, image_seq_len] row, zero-padded past the given tokens —
        every decode goes through this one shape (``_img_batch``)."""
        n = self.dalle.cfg.image_seq_len
        row = np.zeros((1, n), np.int64)
        t = np.asarray(tokens, np.int64).reshape(-1)[:n]
        row[0, :len(t)] = t
        return torch.from_numpy(row).to(self.vae.codebook.weight.device)

    @torch.no_grad()
    def decode(self, tokens) -> torch.Tensor:
        """Image tokens -> one (H, W, C) image on the card."""
        img = vae_mod.decode(self.vae, self._img_batch(tokens),
                             codebook=self.dalle.image_emb.weight)
        return img[0]

    @torch.no_grad()
    def score(self, text_tokens, image: torch.Tensor) -> float:
        """CLIP score of one image against its (text_seq_len,) completed
        text span — ``generate_images``' rerank row."""
        text = torch.as_tensor(np.asarray(text_tokens, np.int64)[None],
                               device=image.device)
        return float(clip_mod.clip_apply(self.clip, text, image[None])[0])

    def _process(self, handle: S.RequestHandle,
                 result: S.Result) -> S.Result:
        t0 = time.perf_counter()
        try:
            image = self.decode(result.tokens)
            if self.clip is not None:
                text = result.text_tokens
                if text is None:       # a result built without an engine
                    text = np.zeros((self.clip.cfg.text_seq_len,), np.int64)
                    codes = list(handle.request.codes)[:len(text)]
                    text[:len(codes)] = codes
                result.clip_score = self.score(text, image)
            result.image = image.float().cpu().numpy()
            self.decoded += 1
        except Exception as e:  # noqa: BLE001 — the handle must resolve
            result = S.Result(
                status=S.ERROR, request_id=result.request_id,
                tokens=result.tokens, reason=f"postprocess: {e!r}",
                queued_s=result.queued_s, decode_s=result.decode_s,
                total_s=result.total_s)
        result.total_s = round(result.total_s + time.perf_counter() - t0, 6)
        return result

    def __call__(self, handle: S.RequestHandle, result: S.Result) -> None:
        """The stage in the caller's thread (the engine's hook when no
        worker runs)."""
        handle.fulfill(self._process(handle, result))

    def _work(self) -> None:
        while not (self._stop.is_set() and self._q.empty()):
            try:
                handle, result = self._q.get(timeout=0.05)
            except queue.Empty:
                continue
            self(handle, result)
