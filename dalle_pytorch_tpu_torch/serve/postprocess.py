"""The post-decode stage: VAE image decode, optional CLIP scoring, and
progressive previews.

Port of ``dalle_pytorch_tpu/serve/postprocess.py`` (``PostProcessor``,
``:30-242``): the engine hands each finished request here (its
``complete`` hook), and its image tokens are decoded through the VAE
with DALLE's tied codebook (``generate_images``' ``vae.decode(img_seq,
codebook=image_emb)``); with a ``clip`` model the image is scored
against the request's completed text span (``models/clip.py::
clip_apply``, whose sparse layers run kernel K3 without the causal
constraint under ``sparse_impl='pallas'``) into ``Result.clip_score``.
The image reaches the host here, so no HTTP thread touches the card.

Previews: the engine's ``on_preview`` hook (``submit_preview``) hands a
streaming request's image-token prefix over; the worker decodes it
through the same zero-padded ``_img_batch`` row as the result and pushes
the frame into the request's sink. A full queue drops the frame
(``preview_drops``): previews never hold the engine. A streamed result's
last frame is its image (``final``), bit for bit.

Two ways to run it. ``start()`` runs a worker thread: ``submit`` (the
engine's hook) queues the request and returns, so image decoding
overlaps token decoding, and ``close()`` drains the queue before it
returns. Called directly (``post(handle, result)``) the stage runs in
the caller's thread. Either way a failure fulfils the handle with
``status='error'``; no handle is dropped. ``on_fulfill`` sees each final
result just before its handle is fulfilled (the server's latency
histograms).
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
                 clip: Optional[clip_mod.CLIP] = None, metrics=None,
                 max_pending: int = 64, on_fulfill=None):
        self.vae = vae
        self.dalle = dalle
        # the tied codebook on the VAE's device (a mesh's DALLE may lie
        # on the CPU)
        self.codebook = dalle.image_emb.weight.to(vae.codebook.weight.device)
        self.clip = clip
        self.metrics = metrics
        self.on_fulfill = on_fulfill
        self.decoded = 0
        # frames delivered (a stream's final frame included), and preview
        # requests shed because the queue was full
        self.preview_frames = 0
        self.preview_drops = 0
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
        self._q.put(("result", handle, result))

    def submit_preview(self, handle: S.RequestHandle, prefix) -> None:
        """The engine's ``on_preview`` hook: queue the image-token prefix
        for a progressive frame, or drop it when the queue is full."""
        try:
            self._q.put_nowait(("preview", handle, prefix))
        except queue.Full:
            self.preview_drops += 1

    def pending(self) -> int:
        return self._q.qsize()

    # -- the stage ------------------------------------------------------------

    def _img_batch(self, tokens) -> torch.Tensor:
        """One [1, image_seq_len] row, zero-padded past the given tokens:
        results, short grids and preview prefixes all decode through this
        one shape, so a stream's final frame is the result's image."""
        n = self.dalle.cfg.image_seq_len
        row = np.zeros((1, n), np.int64)
        t = np.asarray(tokens, np.int64).reshape(-1)[:n]
        row[0, :len(t)] = t
        return torch.from_numpy(row).to(self.vae.codebook.weight.device)

    @torch.no_grad()
    def decode(self, tokens) -> torch.Tensor:
        """Image tokens -> one (H, W, C) image on the card."""
        img = vae_mod.decode(self.vae, self._img_batch(tokens),
                             codebook=self.codebook)
        return img[0]

    @torch.no_grad()
    def score(self, text_tokens, image: torch.Tensor) -> float:
        """CLIP score of one image against its (text_seq_len,) completed
        text span — ``generate_images``' rerank row."""
        text = torch.as_tensor(np.asarray(text_tokens, np.int64)[None],
                               device=image.device)
        return float(clip_mod.clip_apply(self.clip, text, image[None])[0])

    def _trace_span(self, handle: S.RequestHandle,
                    error: bool = False) -> None:
        """The ``postprocess`` span: from the engine's last harvest to
        here, the VAE and CLIP time the caller waited for."""
        tr = getattr(handle, "trace", None)
        if tr is not None:
            meta = {"clip": self.clip is not None}
            if error:
                meta["error"] = True
            tr.span("postprocess", time.perf_counter(), **meta)

    def _fulfill(self, handle: S.RequestHandle, result: S.Result) -> None:
        tr = getattr(handle, "trace", None)
        if tr is not None and result.trace is None:
            # summarised before on_fulfill, which reads the prefill span
            result.trace = tr.summary()
        if self.on_fulfill is not None:
            try:
                self.on_fulfill(result)
            except Exception:   # noqa: BLE001 — a stats hook must never
                pass            # keep the handle from its result
        handle.fulfill(result)

    def _preview(self, handle: S.RequestHandle, prefix) -> None:
        """Decode one progressive frame into the request's sink; a
        handle already terminal skips the decode."""
        sink = getattr(handle, "sink", None)
        if sink is None or handle.done():
            return
        image = self.decode(prefix).float().cpu().numpy()
        sink.push_preview(int(np.asarray(prefix).size), image)
        self.preview_frames += 1

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
            sink = getattr(handle, "sink", None)
            if sink is not None:
                sink.push_preview(int(len(result.tokens)), result.image,
                                  final=True)
                self.preview_frames += 1
            result.total_s = round(result.total_s
                                   + time.perf_counter() - t0, 6)
            self._trace_span(handle)
        except Exception as e:  # noqa: BLE001 — the handle must resolve
            result = S.Result(
                status=S.ERROR, request_id=result.request_id,
                tokens=result.tokens, reason=f"postprocess: {e!r}",
                weights_version=result.weights_version,
                queued_s=result.queued_s, decode_s=result.decode_s,
                total_s=round(result.total_s + time.perf_counter() - t0,
                              6))
            self._trace_span(handle, error=True)
            if self.metrics is not None:
                self.metrics.event(**S.structured_event(
                    "serve_postprocess_error",
                    request_id=result.request_id, error=result.reason))
        return result

    def __call__(self, handle: S.RequestHandle, result: S.Result) -> None:
        """The stage in the caller's thread (the engine's hook when no
        worker runs)."""
        self._fulfill(handle, self._process(handle, result))

    def _work(self) -> None:
        while not (self._stop.is_set() and self._q.empty()):
            try:
                kind, handle, item = self._q.get(timeout=0.05)
            except queue.Empty:
                continue
            if kind == "preview":
                try:
                    self._preview(handle, item)
                except Exception as e:  # noqa: BLE001 — a preview is
                    # best-effort, never a terminal path: recorded, and
                    # the result still comes
                    if self.metrics is not None:
                        self.metrics.event(**S.structured_event(
                            "serve_preview_error",
                            request_id=handle.request.request_id,
                            error=repr(e)))
                continue
            self(handle, item)
