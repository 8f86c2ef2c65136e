"""KWT, the Keyword Transformer (Berg, O'Connor & Cruz, Interspeech 2021, arXiv:2104.00769), as an ``nn.Module``.

The paper's section 2 and Table 1 (KWT-3: d=192, 3 heads of 64, MLP 768,
12 blocks, 5.37M parameters on 102 tokens):

    x = embed(mfcc)                   # each MFCC frame (40 coefficients) a token: Dense 40 -> d
    x = [class_token; x] + positions  # a learned class token first, learned positions
    for each of the ``depth`` PostNorm blocks:
        x = LN(x + MHSA(x))           # fused QKV d -> 3 * heads * head_dim, softmax(q k^T / sqrt(head_dim)) v,
                                      # then Dense heads * head_dim -> d
        x = LN(x + MLP(x))            # Dense d -> mlp_dim, GELU (erf), Dense mlp_dim -> d
    logits = output(x[:, 0])          # a Dense of the class token, no final LayerNorm

Departures from the paper: 101 frames (the port's frontend; the paper's
gives 98), so 102 tokens; no dropout (the paper's is 0 too); LayerNorm's
eps 1e-5. The JAX package has no transformer, so there is no flax model to
follow: the dtype flow is the port's own. With ``dtype`` bf16:

- parameters are float32;
- every Dense but ``output`` goes through ``layers.dense``: bf16 operands
  and product, the bias added in bf16, float64 weight and bias gradient
  sums (``layers._LowDense``), rounded to bf16 once by ``finish_grads`` as
  every bf16 Dense's;
- the token stream between the blocks, the residual adds, LayerNorm
  (statistics and output) and GELU are float32; the next Dense casts its
  input to bf16;
- attention is ``F.scaled_dot_product_attention`` on bf16 q, k and v (its
  softmax in float32): on CUDA the flash backend, pinned, so that a fall
  back to another path raises instead of running slower;
- the head is ``layers.Output``, float32.

A float32 model is float32 throughout (TF32 off, as the loop sets it), its
attention pinned to the math backend on CUDA.

The parameter gradients that are sums over the batch's rows leave the
model as float64 sums kept by ``layers.wide_grads``: the Dense layers',
LayerNorm's gains and biases (``_LayerNorm``), the class token's and the
position table's (``_Tokens``). So ``finish_grads`` adds them over the ranks
of a data-parallel step and rounds each once, as it does every other leaf.
Nothing else in the model sums over rows: attention, LayerNorm and GELU
act within a clip.

Spans (``metrics.profiling.annotate``): ``attention`` (the core, forward
and backward), ``layer_norm`` (forward, backward and the float64 gain and
bias sums). ``attention_calls`` counts the core's passes, forward and
backward: 2 x ``depth`` a training step.
"""

from __future__ import annotations

import contextlib
from typing import Any

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..metrics.profiling import annotate
from .layers import Output, _keep, _sink, dense

LN_EPS = 1e-5
attention_calls = 0  # the attention core's forward and backward passes (tests, chip_smoke.py)


class KeywordTransformer(nn.Module):
    """Keyword Transformer. Input: (B, frames, n_mfcc) MFCC -> (B, n_labels) logits.

    ``dtype`` is the compute dtype of the Dense layers and of attention
    (``torch.bfloat16`` or None / ``torch.float32``); see the module's
    docstring for what stays float32.
    """

    def __init__(self, config: dict[str, Any], dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype = dtype or torch.float32
        d = config["dim"]
        self.embed = nn.Linear(config["n_mfcc"], d)
        self.class_token = nn.Parameter(torch.zeros(d))
        self.positions = nn.Parameter(torch.zeros(config["frames"] + 1, d))
        self.blocks = nn.ModuleList(Block(d, config["heads"], config["head_dim"], config["mlp_dim"])
                                    for _ in range(config["depth"]))
        self.output = Output(d, config["n_labels"])

    def eval_operands(self) -> None:
        """Nothing to prepare: the eval forward reads the weights as they are."""
        return None

    def forward(self, x: torch.Tensor, packed: Any = None, dropout: Any = None, mesh: Any = None) -> torch.Tensor:
        """Logits, in training and in eval alike. ``packed`` (``eval_operands()``'s None), ``dropout`` and
        ``mesh`` are the other families' and unused: the model has no dropout and sums over no rows in its
        forward, so every model trains and evaluates through one call."""
        b, t, f = x.shape
        tokens = dense(self.embed, x.reshape(b * t, f), self.dtype).view(b, t, -1)
        x = _Tokens.apply(tokens, self.class_token, self.positions)
        for block in self.blocks:
            x = block(x, self.dtype)
        return self.output(x[:, 0])


class Block(nn.Module):
    """One PostNorm encoder block: ``x = LN(x + MHSA(x))``, then ``x = LN(x + MLP(x))``."""

    def __init__(self, d: int, heads: int, head_dim: int, mlp_dim: int):
        super().__init__()
        self.heads, self.head_dim = heads, head_dim
        self.qkv = nn.Linear(d, 3 * heads * head_dim)
        self.proj = nn.Linear(heads * head_dim, d)
        self.norm1 = nn.LayerNorm(d, eps=LN_EPS)
        self.fc1 = nn.Linear(d, mlp_dim)
        self.fc2 = nn.Linear(mlp_dim, d)
        self.norm2 = nn.LayerNorm(d, eps=LN_EPS)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        b, n, d = x.shape
        x = x.reshape(b * n, d)
        q, k, v = dense(self.qkv, x, dtype).view(b, n, 3, self.heads, self.head_dim).permute(2, 0, 3, 1, 4)
        a = attention(q, k, v).transpose(1, 2).reshape(b * n, -1)
        x = layer_norm(self.norm1, x + dense(self.proj, a, dtype).float())
        h = F.gelu(dense(self.fc1, x, dtype).float())
        x = layer_norm(self.norm2, x + dense(self.fc2, h, dtype).float())
        return x.view(b, n, d)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``softmax(q k^T / sqrt(head_dim)) v`` of (B, heads, tokens, head_dim) operands, in their dtype."""
    with annotate("attention"):
        return _Attention.apply(q, k, v)


def _backend(q: torch.Tensor):
    """The pinned backend on CUDA: flash for a low dtype, math for float32 (flash takes no float32)."""
    if q.device.type != "cuda":
        return contextlib.nullcontext()
    from torch.nn.attention import SDPBackend, sdpa_kernel

    return sdpa_kernel(SDPBackend.MATH if q.dtype == torch.float32 else SDPBackend.FLASH_ATTENTION)


class _Attention(torch.autograd.Function):
    """``F.scaled_dot_product_attention`` under the pinned backend, its backward inside the ``attention``
    span: the forward keeps its own graph of the core, which the backward differentiates."""

    @staticmethod
    def forward(ctx, q, k, v):
        global attention_calls
        attention_calls += 1
        track = q.requires_grad or k.requires_grad or v.requires_grad
        leaves = [t.detach().requires_grad_(track) for t in (q, k, v)]
        with torch.set_grad_enabled(track), _backend(q):
            out = F.scaled_dot_product_attention(*leaves)
        ctx.leaves, ctx.out = leaves, out
        return out.detach()

    @staticmethod
    def backward(ctx, g):
        global attention_calls
        attention_calls += 1
        with annotate("attention"):
            grads = torch.autograd.grad(ctx.out, ctx.leaves, g)
        ctx.leaves = ctx.out = None
        return grads


def layer_norm(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """``norm(x)`` of float32 (rows, d) ``x``, its gain and bias gradients float64 sums (``_LayerNorm``)."""
    with annotate("layer_norm"):
        return _LayerNorm.apply(x, norm.weight, norm.bias, norm.eps)


class _LayerNorm(torch.autograd.Function):
    """LayerNorm over the last dimension: forward and input gradient ``native_layer_norm``'s (each row on
    its own), the gain's and the bias's gradients float64 sums over the rows of the exact products
    ``g * x_hat`` and of ``g``, kept by ``wide_grads``."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        y, mean, rstd = torch.native_layer_norm(x, weight.shape, weight, bias, eps)
        ctx.save_for_backward(x, weight, mean, rstd)
        ctx.params, ctx.sink = (weight, bias), _sink()
        return y

    @staticmethod
    def backward(ctx, g):
        with annotate("layer_norm"):
            x, weight, mean, rstd = ctx.saved_tensors
            gx = torch.ops.aten.native_layer_norm_backward(g, x, weight.shape, mean, rstd, weight, None,
                                                           [True, False, False])[0]
            gw = gb = None
            if ctx.needs_input_grad[1]:
                x_hat = ((x - mean) * rstd).double()
                gw = _keep(ctx.sink, ctx.params[0], (g.double() * x_hat).sum(dim=0))
            if ctx.needs_input_grad[2]:
                gb = _keep(ctx.sink, ctx.params[1], g.sum(dim=0, dtype=torch.float64))
        return gx, gw, gb, None


class _Tokens(torch.autograd.Function):
    """``[class_token; tokens] + positions`` in float32 from (B, frames, d) ``tokens``; the class token's
    and the positions' gradients float64 sums over the rows, kept by ``wide_grads``; the tokens' cotangent
    in their dtype."""

    @staticmethod
    def forward(ctx, tokens, class_token, positions):
        b, _, d = tokens.shape
        ctx.params, ctx.sink, ctx.dtype = (class_token, positions), _sink(), tokens.dtype
        return torch.cat([class_token.expand(b, 1, d), tokens.float()], dim=1) + positions

    @staticmethod
    def backward(ctx, g):
        gc = _keep(ctx.sink, ctx.params[0], g[:, 0].sum(dim=0, dtype=torch.float64))
        gp = _keep(ctx.sink, ctx.params[1], g.sum(dim=0, dtype=torch.float64))
        return g[:, 1:].to(ctx.dtype), gc, gp
