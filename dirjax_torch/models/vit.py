"""DINOv2's vision transformer with registers (Oquab et al., DINOv2,
arXiv:2304.07193; Darcet et al., Vision Transformers Need Registers,
arXiv:2309.16588; the public ``dinov2/models/vision_transformer.py``), as
the backbone of the port's GeM descriptor head. Inference only. The JAX
package has no vision transformer, so nothing here has a counterpart there.

For an input of H x W pixels the patch grid is ``h = H // 14`` by
``w = W // 14``, and the tokens run in DINOv2's order: class, the registers,
then the h*w patches, N = 1 + registers + h*w of them.

- Patch embedding: a 14 x 14 stride-14 convolution with bias, computed as one
  GEMM of the (B*h*w, 14*14*3) patch rows of the channels-last input with the
  convolution's weight permuted once to that (ky, kx, c) order. Sizes that
  are not whole patches are floored: the last H mod 14 rows and W mod 14
  columns are dropped, as a stride-14 convolution without padding does
  (DINOv2 asserts divisibility instead).
- Position embeddings: the patch part of the learned ``1 + pos_grid**2``
  table resampled to h x w (bicubic, ``antialias=True``, no
  ``interpolate_offset``: the hub's register models), once per grid and kept
  on the module for the :data:`POS_CACHE_GRIDS` grids used last; the class
  part added to the class token. The registers
  carry none. A grid equal to the table's takes the table as stored, as
  DINOv2 does.
- Blocks (pre-LN): ``y = z + gamma1 * proj(MHA(LN1(z)))``, then
  ``z' = y + gamma2 * fc2(GELU(fc1(LN2(y))))``; the MHA's qkv projection has
  a bias, its heads are 64 wide, ``softmax(q k^T / sqrt(64)) v`` with no
  mask; GELU is exact (erf); LayerNorm's eps is 1e-6.
- The final LayerNorm, on the patch tokens the head pools (DINOv2 norms every
  token; the class and register tokens feed nothing here, so the last
  block's MLP update skips them too).

Each LayerScale residual update runs in one pass with the LayerNorm that
follows it, across block boundaries (``ops/residual_norm.py``, on the card
``csrc/residual_norm.cu``): ``LN1`` of block 0 alone, then each block's
``z += gamma1 * attn`` with its ``LN2``, and ``z += gamma2 * mlp`` with the
next block's ``LN1`` or, after the last block, the final norm on the patch
tokens. So a forward makes 2 * depth + 1 such calls, and each writes the
normed rows straight in the dtype the next layer reads.

Modules are named after DINOv2's state-dict keys (``cls_token``,
``pos_embed``, ``register_tokens``, ``mask_token``, ``patch_embed.proj``,
``blocks.i.{norm1, attn.qkv, attn.proj, ls1.gamma, norm2, mlp.fc1, mlp.fc2,
ls2.gamma}``, ``norm``), so a DINOv2 checkpoint loads with
``load_state_dict``. ``mask_token`` is only read by DINOv2's training.

``dtype`` bf16 computes what ``torch.autocast("cuda", torch.bfloat16)``
gives DINOv2's own module: every linear layer, the patch embedding
included, and the attention take bf16 operands, sum in fp32 and write bf16;
LayerNorm reads and writes fp32; LayerScale widens its bf16 input, so the
residual stream stays fp32; GELU runs on fc1's bf16 output. The fused
pass rounds the fp32 LayerNorm output to bf16 where autocast's next linear
layer would, and keeps the final norm's output fp32. The bf16
weights are cast once and kept while the parameters stay the same (as the
convolution's packed operands are). ``dtype`` fp32 runs everything in fp32.

Attention is torch's ``scaled_dot_product_attention`` pinned to one fused
backend on the card (:data:`ATTENTION_BACKENDS`, by dtype), which raises
where that backend cannot run: a silent drop to the math backend would
store a B x heads x N x N matrix (sixteen 4,020^2 matrices an image at
1022 x 770). On the CPU it is the math backend, the plain path.

The host time of the embedding's launches is the span ``vit.embed``, that of
the blocks' launches (not synchronised, the final norm's included)
``vit.blocks``. :data:`attention_calls` counts the attention calls that
returned, :data:`residual_norm_calls` the fused residual and norm calls
that returned, :data:`pos_embed_builds` the position-embedding resamplings.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.attention import SDPBackend, sdpa_kernel

from ..ops.residual_norm import fused_residual_norm
from ..utils import timer

__all__ = ["ViTConfig", "VIT_CONFIGS", "VisionTransformer", "ATTENTION_BACKENDS",
           "POS_CACHE_GRIDS", "attention", "attention_calls", "residual_norm_calls",
           "pos_embed_builds"]

#: the one fused backend the attention may take on the card, by dtype; a
#: call the backend refuses raises. bf16 takes cuDNN's: 1.30 ms against
#: flash's 1.79 at (8, 16, 4020, 64) on an H100 (PERF.md); fp32, which
#: neither takes, the memory-efficient one
ATTENTION_BACKENDS = {torch.bfloat16: SDPBackend.CUDNN_ATTENTION,
                      torch.float32: SDPBackend.EFFICIENT_ATTENTION}

#: resampled position tables a model keeps, for the grids it used last
POS_CACHE_GRIDS = 4

#: attention calls that returned, in this process (reset them to count a run)
attention_calls = 0
#: fused residual and LayerNorm calls that returned (reset them to count a run)
residual_norm_calls = 0
#: position-embedding resamplings, one a new grid (reset them to count a run)
pos_embed_builds = 0


@dataclass(frozen=True)
class ViTConfig:
    name: str = "vitl14_reg"
    embed_dim: int = 1024
    depth: int = 24
    num_heads: int = 16
    mlp_dim: int = 4096
    patch_size: int = 14
    num_registers: int = 4
    pos_grid: int = 37           # the table's side: pretraining at 518 px
    ln_eps: float = 1e-6

    def grid(self, height: int, width: int) -> Tuple[int, int]:
        """(h, w) whole patches of an input of height x width pixels."""
        return height // self.patch_size, width // self.patch_size


VIT_CONFIGS = {
    # DINOv2 ViT-L/14 with 4 registers (hub dinov2_vitl14_reg)
    "vitl14_reg": ViTConfig(),
}


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(head_dim)) v over (B, heads, N, head_dim), no
    mask: on the card through :data:`ATTENTION_BACKENDS`' backend for the
    dtype, which raises where it cannot run; on the CPU the math backend."""
    global attention_calls
    if q.device.type == "cuda":
        backend = ATTENTION_BACKENDS.get(q.dtype)
        if backend is None:
            raise ValueError(f"no attention backend is pinned for {q.dtype}")
    else:
        backend = SDPBackend.MATH
    with sdpa_kernel([backend]):
        out = F.scaled_dot_product_attention(q, k, v)
    attention_calls += 1
    return out


def _cast(tensors, dtype: torch.dtype, owner: nn.Module, slot: str, make=None):
    """``tensors`` (parameters of ``owner``) in ``dtype`` (through ``make``
    first, if given), made once and kept on ``owner`` under ``slot`` while
    the dtype, their storage and their version counters stay the same: a
    ``load_state_dict``, ``.to()`` or in-place write makes them again."""
    key = (dtype,) + tuple((t.device, t.data_ptr(), t._version) for t in tensors)
    cached = owner.__dict__.get(slot)
    if cached is not None and cached[0] == key:
        return cached[1]
    with torch.inference_mode(False), torch.no_grad():
        made = tuple(t.detach() for t in tensors) if make is None else make(*tensors)
        made = tuple(t.to(dtype).contiguous() for t in made)
    owner.__dict__[slot] = (key, made)
    return made


def _linear(x: torch.Tensor, lin: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """``lin`` on ``x`` (already in ``dtype``) with its weights in ``dtype``."""
    if dtype == torch.float32:
        return F.linear(x, lin.weight, lin.bias)
    return F.linear(x, *_cast((lin.weight, lin.bias), dtype, lin, "_cast_operands"))


def _residual_norm(z: torch.Tensor, y, scale, norm: nn.LayerNorm,
                   dtype: torch.dtype) -> torch.Tensor:
    """``z += scale.gamma * y`` (where ``y`` is given), then ``norm`` of
    ``z`` in ``dtype``, in one pass (:func:`ops.residual_norm.fused_residual_norm`)."""
    global residual_norm_calls
    out = fused_residual_norm(z, y, None if scale is None else scale.gamma, norm.weight,
                              norm.bias, norm.eps, dtype)
    residual_norm_calls += 1
    return out


class LayerScale(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))


class Attention(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.heads = cfg.num_heads
        self.qkv = nn.Linear(cfg.embed_dim, 3 * cfg.embed_dim)
        self.proj = nn.Linear(cfg.embed_dim, cfg.embed_dim)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        B, N, D = x.shape
        qkv = _linear(x, self.qkv, dtype).view(B, N, 3, self.heads, D // self.heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
        # (B, heads, N, hd) -> (B, N, D): a view where the backend writes N-major
        out = attention(q, k, v).transpose(1, 2).reshape(B, N, D)
        return _linear(out, self.proj, dtype)


class Mlp(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.fc1 = nn.Linear(cfg.embed_dim, cfg.mlp_dim)
        self.fc2 = nn.Linear(cfg.mlp_dim, cfg.embed_dim)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return _linear(F.gelu(_linear(x, self.fc1, dtype)), self.fc2, dtype)


class Block(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.norm1 = nn.LayerNorm(cfg.embed_dim, eps=cfg.ln_eps)
        self.attn = Attention(cfg)
        self.ls1 = LayerScale(cfg.embed_dim)
        self.norm2 = nn.LayerNorm(cfg.embed_dim, eps=cfg.ln_eps)
        self.mlp = Mlp(cfg)
        self.ls2 = LayerScale(cfg.embed_dim)


class PatchEmbed(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        p = cfg.patch_size
        self.proj = nn.Conv2d(3, cfg.embed_dim, p, p)


class VisionTransformer(nn.Module):
    """DINOv2's backbone (see the module docstring); :meth:`patch_map` gives
    the final-normed patch tokens as an fp32 (B, h, w, D) map."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        d = cfg.embed_dim
        self.vit_cfg = cfg
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + cfg.pos_grid ** 2, d))
        self.register_tokens = nn.Parameter(torch.zeros(1, cfg.num_registers, d))
        self.mask_token = nn.Parameter(torch.zeros(1, d))
        self.patch_embed = PatchEmbed(cfg)
        self.blocks = nn.ModuleList(Block(cfg) for _ in range(cfg.depth))
        self.norm = nn.LayerNorm(d, eps=cfg.ln_eps)

    def _patch_operands(self, dtype: torch.dtype):
        """The patch embedding's (D, 14*14*3) weight in (ky, kx, c) order and
        its bias, in ``dtype``."""
        conv = self.patch_embed.proj
        return _cast((conv.weight, conv.bias), dtype, conv, "_gemm_operands",
                     lambda w, b: (w.detach().permute(0, 2, 3, 1).reshape(w.shape[0], -1),
                                   b.detach()))

    def _patch_pos(self, h: int, w: int) -> torch.Tensor:
        """The patch part of the position embedding on the h x w grid, (h*w,
        D) fp32, resampled once per grid while the grid stays among the last
        :data:`POS_CACHE_GRIDS` used (:data:`pos_embed_builds`)."""
        global pos_embed_builds
        table = self.pos_embed
        key = (table.device, table.data_ptr(), table._version)
        cache = self.__dict__.get("_pos_cache")
        if cache is None or cache[0] != key:
            cache = self.__dict__["_pos_cache"] = (key, {})
        grids = cache[1]                    # oldest use first
        got = grids.pop((h, w), None)
        if got is None:
            m, d = self.vit_cfg.pos_grid, table.shape[-1]
            with torch.inference_mode(False), torch.no_grad():
                grid = table.detach()[0, 1:].float().reshape(1, m, m, d).permute(0, 3, 1, 2)
                if (h, w) != (m, m):
                    grid = F.interpolate(grid, size=(h, w), mode="bicubic", antialias=True)
                got = grid.permute(0, 2, 3, 1).reshape(h * w, d).contiguous()
            pos_embed_builds += 1
            if len(grids) >= POS_CACHE_GRIDS:
                del grids[next(iter(grids))]
        grids[(h, w)] = got
        return got

    def patch_map(self, images: torch.Tensor, dtype: torch.dtype = torch.float32
                  ) -> torch.Tensor:
        """``images``: NCHW float, already normalized (channels_last storage
        reads without a copy). Returns the final-normed patch tokens as a
        contiguous fp32 (B, h, w, D) map."""
        cfg = self.vit_cfg
        B, _, H, W = images.shape
        p, d = cfg.patch_size, cfg.embed_dim
        h, w = cfg.grid(H, W)
        if h == 0 or w == 0:
            raise ValueError(f"an input of {H}x{W} holds no whole {p}x{p} patch")
        front = 1 + cfg.num_registers
        with timer.span("vit.embed", B):
            x = images.permute(0, 2, 3, 1)[:, :h * p, :w * p]
            rows = (x.reshape(B, h, p, w, p, 3).permute(0, 1, 3, 2, 4, 5).to(dtype)
                    .reshape(B * h * w, p * p * 3))
            patches = F.linear(rows, *self._patch_operands(dtype)).view(B, h * w, d)
            z = torch.empty((B, front + h * w, d), dtype=torch.float32, device=images.device)
            z[:, 0] = self.cls_token[0, 0] + self.pos_embed[0, 0]
            z[:, 1:front] = self.register_tokens[0]
            torch.add(patches, self._patch_pos(h, w), out=z[:, front:])
        with timer.span("vit.blocks", B):
            # z, the fp32 stream, is updated in place; a, the normed rows
            # the next branch reads
            blocks = self.blocks
            a = _residual_norm(z, None, None, blocks[0].norm1, dtype)
            for i, blk in enumerate(blocks):
                a = _residual_norm(z, blk.attn(a, dtype), blk.ls1, blk.norm2, dtype)
                if i + 1 < len(blocks):
                    a = _residual_norm(z, blk.mlp(a, dtype), blk.ls2, blocks[i + 1].norm1, dtype)
                else:   # the final norm, on the patch tokens alone, in fp32
                    a = _residual_norm(z[:, front:], blk.mlp(a, dtype)[:, front:], blk.ls2,
                                       self.norm, torch.float32)
        return a.view(B, h, w, d)
