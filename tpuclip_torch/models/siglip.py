"""SigLIP vision + text towers in PyTorch.

Port of ``tpuclip/models/siglip.py`` with the same numerics contract:

- matmuls run in the compute dtype (bf16 on CUDA, fp32 on the CPU) with
  fp32 accumulation; bias adds, LayerNorm statistics and affine, gelu-tanh,
  attention logits and softmax are computed in fp32 and rounded once.
  PyTorch's own ops keep that contract fused for bf16 inputs (``F.linear``
  adds the bias to the fp32 accumulator, ``F.layer_norm`` and ``F.gelu``
  compute in fp32 internally), so each is one pass over the activations;
- attention (:func:`attend`) is one hand-written kernel on the card
  (kernel 9, :func:`tpuclip_torch.ops.attention.attention`) for bf16 inputs
  that need no gradient: it reads the q / k / v projections in place and
  keeps the fp32 logits on chip. At SigLIP's 256-patch / 64-token
  sequences attention is a few percent of the tower's FLOPs, but as a
  chain of PyTorch operators its fp32 logits' round trips through device
  memory took over half the tower's time. Everywhere else (the CPU, fp32,
  training) it is explicit matmuls, as the JAX tower's einsum is, which
  autograd differentiates;
- each residual add and the LayerNorm after it (:func:`add_norm`) are one
  hand-written pass on the card (kernel 10,
  :func:`tpuclip_torch.ops.layernorm.add_layer_norm`) for bf16 inputs that
  need no gradient: the encoder layers carry the MLP's output as a pending
  residual, which the next layer's first LayerNorm, or the tower's final
  one, adds as it reads the stream. The sum is rounded once, as the add
  rounds it, and the statistics come from the rounded sum. Everywhere else
  it is the add, then ``F.layer_norm``;
- the patch embedding is a reshape into (B, patches, P*P*C) patch rows in
  (ph, pw, c) order followed by one GEMM, on uint8 NHWC input normalised
  as x/127.5 - 1 inside the tower.

Each sublayer runs inside a :func:`~tpuclip_torch.utils.profiling.span`
(``tower.patch``, ``tower.attn`` around the projections, ``tower.attn.core``
around the attention kernel, or the logits, softmax and weighted sum,
``tower.mlp``, ``tower.head``)
that a profiler's trace shows; without a profiler each is a flag check.

Layers are an ``nn.ModuleList`` looped in Python (the JAX tower scans a
stacked layer axis). Training calls the towers directly (``model.vision``,
``model.text``) on fp32 parameters that require grad, with the compute
dtype as an argument, under :func:`remat_scope`, which recomputes each
layer's activations in the backward pass (tpuclip's ``remat_scope``). Linear weights use PyTorch's (out, in) layout;
``tpuclip_torch.models.convert.load_jax_params`` transposes the JAX
package's (in, out) kernels on load.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from tpuclip_torch.models.configs import SiglipConfig, TextConfig, VisionConfig
from tpuclip_torch.ops.attention import attention, attention_plain
from tpuclip_torch.ops.layernorm import add_layer_norm, add_layer_norm_plain
from tpuclip_torch.utils.profiling import span

# =============================================================================
# Primitive blocks
# =============================================================================


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm with fp32 statistics regardless of compute dtype."""
    return F.layer_norm(x, x.shape[-1:], weight.to(x.dtype), bias.to(x.dtype), eps)


def dense(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """``x @ W.T + b`` in the input dtype, accumulated in fp32; ``x @ W.T``
    for a layer without a bias (DINOv3's k projection)."""
    bias = None if layer.bias is None else layer.bias.to(x.dtype)
    return F.linear(x, layer.weight.to(x.dtype), bias)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """HF ``gelu_pytorch_tanh``, computed in fp32 for bf16 inputs."""
    return F.gelu(x, approximate="tanh")


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)


def add_norm(
    x: torch.Tensor, delta: Optional[torch.Tensor], ln: LayerNorm, scale: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The pending residual ``delta`` added to ``x`` (``delta`` None: none;
    with ``scale``, a (D,) LayerScale, ``scale * delta``) and LayerNorm
    ``ln`` of the sum: ``(x + delta, ln(x + delta))``.

    bf16 on CUDA with no gradient goes to
    :func:`~tpuclip_torch.ops.layernorm.add_layer_norm` (kernel 10, one
    pass); fp32, the CPU and anything autograd must differentiate to the add
    and ``F.layer_norm`` of
    :func:`~tpuclip_torch.ops.layernorm.add_layer_norm_plain`."""
    args = (x, delta, ln.weight, ln.bias, ln.eps, scale)
    grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (x, delta, ln.weight, ln.bias, scale))
    if x.device.type != "cuda" or x.dtype != torch.bfloat16 or grad:
        return add_layer_norm_plain(*args)
    return add_layer_norm(*args)


def _key_bias(mask: Optional[torch.Tensor], batch: int, sk: int) -> Optional[torch.Tensor]:
    """An additive (B or 1, 1, 1, Sk) key mask, the form the towers build,
    as the (B, Sk) bias the attention kernel takes (a view); any other mask
    as it is (the kernel refuses it)."""
    if mask is not None and mask.dim() == 4 and mask.shape[1] == mask.shape[2] == 1 and mask.shape[3] == sk:
        return mask[:, 0, 0, :].expand(batch, sk)
    return mask


def attend(
    q_in: torch.Tensor, kv_in: torch.Tensor, wq: nn.Linear, wk: nn.Linear, wv: nn.Linear,
    num_heads: int, mask: Optional[torch.Tensor] = None, rope: Optional[Callable] = None,
) -> torch.Tensor:
    """The heads of ``wq`` / ``wk`` / ``wv`` (``num_heads`` of them, contiguous
    in the projections' output, as ``view(b, s, h, hd)`` reads it) attending
    from ``q_in`` (B, Sq, D) over ``kv_in`` (B, Sk, D): the heads' outputs
    (B, Sq, num_heads * hd), before the output projection. Scale
    1/sqrt(head_dim), fp32 logits and softmax; ``mask`` additive,
    broadcastable to (B, num_heads, Sq, Sk). ``rope``, where given, maps the
    projected ``(q, k)`` to their rotated pair before the attention (DINOv3's
    rotary positions, inside the ``tower.attn.rope`` span).

    bf16 projections that need no gradient go to
    :func:`~tpuclip_torch.ops.attention.attention` (on the card, kernel 9,
    with the mask as a (B, Sk) key bias); fp32 ones, and any that autograd
    must differentiate, to the explicit matmuls of
    :func:`~tpuclip_torch.ops.attention.attention_plain`."""
    q, k, v = dense(q_in, wq), dense(kv_in, wk), dense(kv_in, wv)
    if rope is not None:
        with span("tower.attn.rope"):
            q, k = rope(q, k)
    with span("tower.attn.core"):
        grad = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad)
        if q.dtype != torch.bfloat16 or grad:
            return attention_plain(q, k, v, num_heads, mask)
        return attention(q, k, v, num_heads, _key_bias(mask, q.shape[0], k.shape[1]))


class Attention(nn.Module):
    """Multi-head attention, HF SiglipAttention eager semantics
    (:func:`attend`, then the output projection); ``key_bias`` False leaves
    the k projection without a bias (DINOv3)."""

    def __init__(self, dim: int, num_heads: int, key_bias: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.q = nn.Linear(dim, dim)
        self.k = nn.Linear(dim, dim, bias=key_bias)
        self.v = nn.Linear(dim, dim)
        self.o = nn.Linear(dim, dim)

    def forward(
        self, q_in: torch.Tensor, kv_in: torch.Tensor, mask: Optional[torch.Tensor] = None,
        rope: Optional[Callable] = None,
    ) -> torch.Tensor:
        with span("tower.attn"):
            return dense(attend(q_in, kv_in, self.q, self.k, self.v, self.num_heads, mask, rope), self.o)


class MLP(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span("tower.mlp"):
            return dense(gelu_tanh(dense(x, self.fc1)), self.fc2)


class EncoderLayer(nn.Module):
    """Pre-LN block (SiglipEncoderLayer): x += attn(LN1(x)); x += mlp(LN2(x)),
    with the MLP's add left pending for the next LayerNorm (:func:`add_norm`)."""

    def __init__(self, cfg):
        super().__init__()
        d = cfg.hidden_size
        self.ln1 = LayerNorm(d, cfg.layer_norm_eps)
        self.attn = Attention(d, cfg.num_heads)
        self.ln2 = LayerNorm(d, cfg.layer_norm_eps)
        self.mlp = MLP(d, cfg.intermediate_size)

    def forward(
        self, x: torch.Tensor, delta: Optional[torch.Tensor] = None, mask: Optional[torch.Tensor] = None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The residual stream ``x`` and the previous layer's pending MLP
        output ``delta`` (None for the first layer) → this layer's stream
        after attention and its MLP output, still to be added."""
        x, h = add_norm(x, delta, self.ln1)
        x, h = add_norm(x, self.attn(h, h, mask), self.ln2)
        return x, self.mlp(h)


class Encoder(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.layers = nn.ModuleList(EncoderLayer(cfg) for _ in range(cfg.num_layers))
        # Set only inside remat_scope: each layer's activations are then
        # recomputed in the backward pass instead of kept.
        self.remat = False

    def forward(
        self, x: torch.Tensor, mask: Optional[torch.Tensor] = None
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """→ ``(x, delta)``: the stream and the last layer's MLP output, whose
        add the caller folds into its final LayerNorm (:func:`add_norm`)."""
        delta = None
        for layer in self.layers:
            if self.remat and torch.is_grad_enabled():
                x, delta = checkpoint(layer, x, delta, mask, use_reentrant=False)
            else:
                x, delta = layer(x, delta, mask)
        return x, delta


@contextmanager
def remat_scope(model: nn.Module):
    """Per-layer activation checkpointing of every encoder in ``model``
    while the block runs (tpuclip's ``remat_scope``: at SO400M the stashed
    activations of 27 layers, the (B, 256, 4304) MLP ones among them,
    would otherwise be kept for the backward pass)."""
    encoders = [m for m in model.modules() if isinstance(m, Encoder)]
    for enc in encoders:
        enc.remat = True
    try:
        yield
    finally:
        for enc in encoders:
            enc.remat = False


# =============================================================================
# Vision tower
# =============================================================================


def normalize_pixels(pixel_values: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """uint8 [0,255] NHWC → x/127.5 - 1 in ``dtype``; float inputs pass
    through. The constants are rounded to ``dtype`` first, as the JAX
    tower's are; they are filled on the device (no host copy), so the
    tower can be captured in a CUDA graph."""
    if pixel_values.dtype == torch.uint8:
        x = pixel_values.to(dtype)
        one = torch.ones((), dtype=dtype, device=x.device)
        return x * torch.full((), 1.0 / 127.5, dtype=dtype, device=x.device) - one
    return pixel_values.to(dtype)


class MAPHead(nn.Module):
    """Multihead attention pooling (SiglipMultiheadAttentionPoolingHead): a
    learned probe cross-attends over the patch tokens, then LN + residual
    MLP; returns the probe token."""

    def __init__(self, cfg: VisionConfig):
        super().__init__()
        d = cfg.hidden_size
        self.probe = nn.Parameter(torch.zeros(1, d))
        self.attn = Attention(d, cfg.num_heads)
        self.ln = LayerNorm(d, cfg.layer_norm_eps)
        self.mlp = MLP(d, cfg.intermediate_size)

    def forward(self, hidden: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``mask``: additive (B, 1, 1, S) over padded patch keys (NaFlex)."""
        b, _, d = hidden.shape
        probe = self.probe.to(hidden.dtype).expand(b, 1, d)
        attn_out = self.attn(probe, hidden, mask)
        y = attn_out + self.mlp(self.ln(attn_out))
        return y[:, 0]


class VisionTower(nn.Module):
    def __init__(self, cfg: VisionConfig):
        super().__init__()
        self.cfg = cfg
        patch_in = cfg.patch_size * cfg.patch_size * cfg.num_channels
        self.patch = nn.Linear(patch_in, cfg.hidden_size)
        self.pos_embed = nn.Parameter(torch.zeros(cfg.num_patches, cfg.hidden_size))
        self.encoder = Encoder(cfg)
        self.post_ln = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.head = MAPHead(cfg)

    def patch_embed(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC (B, H, W, C) → (B, patches, D): patch rows flattened in
        (ph, pw, c) order, patches in row-major grid order, one GEMM.
        Pixels past the last whole patch are dropped, as HF's Conv2d with
        stride = kernel drops them (384 px at patch 14: a 27 x 27 grid over
        the first 378 rows and columns)."""
        b, h, w, c = x.shape
        ps = self.cfg.patch_size
        hp, wp = h // ps, w // ps
        x = x[:, : hp * ps, : wp * ps].reshape(b, hp, ps, wp, ps, c).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(b, hp * wp, ps * ps * c)
        return dense(x, self.patch)

    def forward(self, pixel_values: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """(B, H, W, C) uint8 or pre-normalised float → pooled (B, D)."""
        with span("tower.patch"):
            x = self.patch_embed(normalize_pixels(pixel_values, dtype))
            x = x + self.pos_embed.to(x.dtype)
        x, delta = self.encoder(x)
        with span("tower.head"):
            return self.head(add_norm(x, delta, self.post_ln)[1])


# =============================================================================
# Text tower
# =============================================================================


class TextTower(nn.Module):
    def __init__(self, cfg: TextConfig):
        super().__init__()
        self.cfg = cfg
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.pos_embed = nn.Parameter(torch.zeros(cfg.max_length, cfg.hidden_size))
        self.encoder = Encoder(cfg)
        self.final_ln = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.head = nn.Linear(cfg.hidden_size, cfg.projection_size)

    def forward(
        self,
        input_ids: torch.Tensor,
        dtype: torch.dtype,
        attention_mask: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """(B, S) ids (+ (B, S) 1/0 keep-mask) → projected (B, proj).

        Pooling takes the LAST position's hidden state (SigLIP pads to
        exactly ``max_length``). The additive key mask is built in fp32:
        ``finfo(f32).min`` overflows bf16."""
        ids = input_ids.long()
        x = self.token_embedding.weight[ids].to(dtype)
        x = x + self.pos_embed[: ids.shape[-1]].to(dtype)[None]
        mask4d = None
        if attention_mask is not None:
            keep = attention_mask.float()
            mask4d = ((1.0 - keep) * torch.finfo(torch.float32).min)[:, None, None, :]
        hidden = add_norm(*self.encoder(x, mask4d), self.final_ln)[1]
        return dense(hidden[:, -1, :], self.head)


# =============================================================================
# Model
# =============================================================================


class SiglipModel(nn.Module):
    """Both towers plus the (training-only) logit scale and bias."""

    def __init__(self, cfg: SiglipConfig):
        super().__init__()
        self.cfg = cfg
        self.vision = VisionTower(cfg.vision)
        self.text = TextTower(cfg.text)
        self.logit_scale = nn.Parameter(torch.tensor(math.log(10.0)))
        self.logit_bias = nn.Parameter(torch.tensor(-10.0))

    @property
    def dtype(self) -> torch.dtype:
        return self.vision.pos_embed.dtype

    @torch.inference_mode()
    def get_image_features(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """L2-normalised fp32 image embeddings (B, D); divides by
        max(norm, 1e-12) like F.normalize."""
        pooled = self.vision(pixel_values, self.dtype).float()
        norm = torch.linalg.vector_norm(pooled, dim=-1, keepdim=True)
        return pooled / norm.clamp_min(1e-12)

    @torch.inference_mode()
    def get_image_features_naflex(
        self, patches: torch.Tensor, pixel_mask: torch.Tensor, spatial_shapes: torch.Tensor
    ) -> torch.Tensor:
        """NaFlex towers: uint8 patches (B, L, P*P*C), mask (B, L) and patch
        grids (B, 2) → L2-normalised fp32 (B, D)
        (:func:`tpuclip_torch.models.naflex.get_image_features_naflex`)."""
        from tpuclip_torch.models.naflex import get_image_features_naflex

        return get_image_features_naflex(self, patches, pixel_mask, spatial_shapes)

    def image_features(self, *inputs: torch.Tensor) -> torch.Tensor:
        """The vision tower in this model's input format: NaFlex's (patches,
        masks, patch grids) through :meth:`get_image_features_naflex`,
        otherwise square uint8 pixels through :meth:`get_image_features`.
        The entry is looked up at call time, so a replacement set on the
        instance is the one that runs."""
        name = "get_image_features_naflex" if self.cfg.vision.naflex else "get_image_features"
        return getattr(self, name)(*inputs)

    @torch.inference_mode()
    def get_text_features(
        self, input_ids: torch.Tensor, attention_mask: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        """L2-normalised fp32 text embeddings (B, proj); divides by
        norm + 1e-12."""
        pooled = self.text(input_ids, self.dtype, attention_mask).float()
        norm = torch.linalg.vector_norm(pooled, dim=-1, keepdim=True)
        return pooled / (norm + 1e-12)


@torch.no_grad()
def init_params_(model: SiglipModel, generator: torch.Generator) -> SiglipModel:
    """Random init with the distributions of tpuclip's ``init_params``:
    linear weights N(0, 1/fan_in), zero biases, unit LayerNorm scales,
    N(0, 0.02²) token/position embeddings, N(0, 1) pooling probe, logit
    scale log(10) and bias -10. Draws come from ``generator`` on the
    generator's device, in fp32, then land in each parameter's dtype."""
    device = generator.device

    def normal_(p: torch.Tensor, std: float) -> None:
        draw = torch.randn(p.shape, generator=generator, device=device, dtype=torch.float32)
        p.copy_(draw.mul_(std))

    for module in model.modules():
        if isinstance(module, nn.Linear):
            normal_(module.weight, 1.0 / math.sqrt(module.in_features))
            module.bias.zero_()
        elif isinstance(module, LayerNorm):
            module.weight.fill_(1.0)
            module.bias.zero_()
    normal_(model.vision.pos_embed, 0.02)
    normal_(model.vision.head.probe, 1.0)
    normal_(model.text.token_embedding.weight, 0.02)
    normal_(model.text.pos_embed, 0.02)
    model.logit_scale.fill_(math.log(10.0))
    model.logit_bias.fill_(-10.0)
    return model


def build_model(cfg: SiglipConfig, device: torch.device, dtype: torch.dtype) -> SiglipModel:
    """Uninitialised model allocated directly on ``device`` in ``dtype``
    (built on the meta device, so no throwaway default init runs)."""
    with torch.device("meta"):
        model = SiglipModel(cfg)
    return model.to(dtype=dtype).to_empty(device=device).eval().requires_grad_(False)
