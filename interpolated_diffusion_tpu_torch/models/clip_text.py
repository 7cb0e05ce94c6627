"""Frozen CLIP text encoder, host-side preparation (port of
models/clip_text.py, a copy).

Text embeddings from a frozen pretrained CLIP (pooled, or the unpooled
[L, text_dim] token states the DiDeMo trainers condition on) at cache-build
time (data/precompute_clip_cache.py); the trainers read the stored
embeddings. Needs the `transformers` package and the model's weights, and
raises ImportError without the package.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np


class CLIPTextEncoder:
    def __init__(self, model_name: str = "openai/clip-vit-base-patch32", device: str = "cpu"):
        try:
            import torch
            from transformers import CLIPTextModel, CLIPTokenizer
        except ImportError as e:
            raise ImportError("CLIPTextEncoder needs transformers + torch (cache building "
                              "only)") from e
        self._torch = torch
        self.tokenizer = CLIPTokenizer.from_pretrained(model_name)
        self.model = CLIPTextModel.from_pretrained(model_name).to(device).eval()
        self.device = device
        self.text_dim = int(self.model.config.hidden_size)

    def encode(self, texts: List[str], pooled: bool = True,
               max_length: Optional[int] = None) -> np.ndarray:
        torch = self._torch
        tok = self.tokenizer(texts, padding="max_length", truncation=True,
                             max_length=max_length or self.tokenizer.model_max_length,
                             return_tensors="pt").to(self.device)
        with torch.no_grad():
            out = self.model(**tok)
        if pooled:
            return out.pooler_output.cpu().numpy().astype(np.float32)
        return out.last_hidden_state.cpu().numpy().astype(np.float32)
