"""Serving engine, static-batch path (port of ``ServeEngine.generate`` in
``repro.serve.engine``).

``generate`` left-pads a batch of prompts to one length (with token 0; causal
attention attends to those pads, as in the JAX package), prefills a dense
KV cache in one forward over the padded batch, then runs ``max_new`` greedy
decode steps, one token per slot each.  Precision follows the engine's
``PrecisionPolicy`` (``serve_default`` unless given), hot-swappable with
:meth:`ServeEngine.set_policy`.  Kernels run on the device the engine was
built for: ``cuda`` unless the caller passes ``device="cpu"``, where every
kernel wrapper runs its plain PyTorch version.

Not ported yet: pre-limbed decode weights, the paged continuous scheduler,
and mixed-format lanes (ROADMAP.md, slices 2 and 3).
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import context as context_lib
from repro_torch.core.policy import PrecisionPolicy
from repro_torch.models import transformer as T


def make_prefill_step(cfg: ModelConfig, policy: PrecisionPolicy):
    """(params, inputs, cache) -> (last-position logits (B, 1, V), cache)."""
    def prefill_step(params, inputs, cache):
        logits, new_cache = T.forward(params, inputs, cfg, policy, cache=cache)
        return logits[:, -1:, :], new_cache

    return prefill_step


def make_serve_step(cfg: ModelConfig, policy: PrecisionPolicy):
    """(params, cache, tokens (B, 1)) -> (logits (B, 1, V), cache)."""
    def serve_step(params, cache, tokens):
        return T.forward(params, {"tokens": tokens}, cfg, policy, cache=cache)

    return serve_step


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, device) for v in tree)
    return tree.to(device)


class ServeEngine:
    """Batched greedy generation over a dense KV cache of ``max_batch``
    slots x ``max_seq`` positions.

    ``prelimb_weights`` defaults to False and only False is supported: the
    JAX engine's pre-limbed decode (weights split into bf16 limb stacks once
    per policy, fed to the pre-limbed matmul kernel) needs the decompose and
    pre-limbed kernels, which come with slice 2 of the port (ROADMAP.md).
    Until then decode limbs the raw weights inside the fused kernels —
    numerically the same limbs — and asking for True raises rather than
    silently serving raw weights.  ``matmul_backend`` names the dispatch
    backend (``"cuda"``, the kernels, unless the active context says
    otherwise; ``"ref"`` for the oracle)."""

    def __init__(self, cfg: ModelConfig, params, *, max_batch: int = 8,
                 max_seq: int = 512, policy: Optional[PrecisionPolicy] = None,
                 matmul_backend: Optional[str] = None,
                 prelimb_weights: bool = False, device: str = "cuda"):
        if prelimb_weights:
            raise NotImplementedError(
                "prelimb_weights=True needs the decompose and pre-limbed "
                "kernels: see ROADMAP.md 'Slice 2: the continuous scheduler'")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("ServeEngine(device='cuda') needs a CUDA "
                               "device; pass device='cpu' to run the plain "
                               "versions on the CPU")
        self.cfg = cfg
        self.params = _to_device(params, self.device)
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.prelimb_weights = prelimb_weights
        self.matmul_backend = (matmul_backend
                               or context_lib.current_context().backend)
        self.set_policy(policy or context_lib.current_context().policy
                        or PrecisionPolicy.serve_default())

    def set_policy(self, policy: Union[PrecisionPolicy, str, bytes, dict]
                   ) -> PrecisionPolicy:
        """Hot-swap the precision policy for all subsequent steps (accepts a
        ``PrecisionPolicy`` or its JSON wire form).  Returns it."""
        if not isinstance(policy, PrecisionPolicy):
            policy = PrecisionPolicy.from_json(policy)
        self.policy = policy
        self._prefill = make_prefill_step(self.cfg, policy)
        self._decode = make_serve_step(self.cfg, policy)
        return policy

    def make_cache(self) -> T.ModelCache:
        return T.make_cache(self.cfg, self.max_batch, self.max_seq,
                            dtype=torch.float32, device=self.device)

    def prefill(self, tokens: np.ndarray, cache: T.ModelCache):
        """Run the prefill step on (max_batch, L) tokens under the engine's
        backend."""
        with torch.no_grad(), \
                context_lib.context(backend=self.matmul_backend):
            toks = torch.as_tensor(tokens, dtype=torch.long,
                                   device=self.device)
            return self._prefill(self.params, {"tokens": toks}, cache)

    def decode(self, cache: T.ModelCache, tokens: torch.Tensor):
        """Run one decode step on (max_batch, 1) tokens."""
        with torch.no_grad(), \
                context_lib.context(backend=self.matmul_backend):
            return self._decode(self.params, cache, tokens)

    def pad_prompts(self, prompts: List[np.ndarray]) -> np.ndarray:
        """Left-pad prompts with token 0 into a (max_batch, L) batch."""
        B = len(prompts)
        if not 1 <= B <= self.max_batch:
            raise ValueError(f"{B} prompts for {self.max_batch} slots")
        L = max(len(p) for p in prompts)
        toks = np.zeros((self.max_batch, L), np.int64)
        for i, p in enumerate(prompts):
            toks[i, L - len(p):] = p
        return toks

    def generate(self, prompts: List[np.ndarray], max_new: int = 16
                 ) -> List[List[int]]:
        """Batched greedy generation: pads prompts to one bucket, prefills
        the cache, then runs ``max_new`` decode steps."""
        B = len(prompts)
        toks = self.pad_prompts(prompts)
        if toks.shape[1] + max_new > self.max_seq:
            raise ValueError(f"prompt {toks.shape[1]} + {max_new} new tokens "
                             f"exceed max_seq {self.max_seq}")
        cache = self.make_cache()
        logits, cache = self.prefill(toks, cache)
        cur = logits[:, -1, :].argmax(dim=-1)[:, None]
        outs: List[List[int]] = [[] for _ in range(B)]
        for _ in range(max_new):
            host = cur[:B, 0].tolist()
            for i in range(B):
                outs[i].append(int(host[i]))
            logits, cache = self.decode(cache, cur)
            cur = logits[:, -1, :].argmax(dim=-1)[:, None]
        return outs

    def decode_throughput_probe(self, steps: int = 8) -> Dict[str, float]:
        """Timing probe: decode tokens/s at the full slot batch."""
        cache = self.make_cache()
        tok = torch.zeros((self.max_batch, 1), dtype=torch.long,
                          device=self.device)
        logits, cache = self.decode(cache, tok)  # warm-up (kernel builds)
        self._sync()
        t0 = time.perf_counter()
        for _ in range(steps):
            logits, cache = self.decode(cache, tok)
        self._sync()
        dt = time.perf_counter() - t0
        return {"tokens_per_s": self.max_batch * steps / dt,
                "ms_per_step": dt / steps * 1e3}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
