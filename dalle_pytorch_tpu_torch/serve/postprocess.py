"""Image decoding of finished requests.

Port of the VAE stage of ``dalle_pytorch_tpu/serve/postprocess.py``:
the engine hands each finished request here (its ``complete`` hook),
and its image tokens are decoded through the VAE with DALLE's tied
codebook (``generate_images``' ``vae.decode(img_seq, codebook=
image_emb)``). The call is synchronous: the JAX package's worker thread,
previews and the CLIP re-rank come with the HTTP server's slice.
"""

from __future__ import annotations

import numpy as np
import torch

from dalle_pytorch_tpu_torch.models import dalle as D
from dalle_pytorch_tpu_torch.models import vae as vae_mod
from dalle_pytorch_tpu_torch.serve import scheduler as S


class PostProcessor:
    """``complete(handle, result)`` for the engine: decode, attach the
    (H, W, C) float32 image to the result, fulfil the handle."""

    def __init__(self, vae: vae_mod.VAEDecoder, dalle: D.DALLE):
        self.vae = vae
        self.dalle = dalle

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

    def __call__(self, handle: S.RequestHandle, result: S.Result) -> None:
        try:
            result.image = self.decode(result.tokens).float().cpu().numpy()
        except (RuntimeError, ValueError) as e:
            result = S.Result(status=S.ERROR, request_id=result.request_id,
                              reason=f"image decode failed: {e!r}")
        handle.fulfill(result)
