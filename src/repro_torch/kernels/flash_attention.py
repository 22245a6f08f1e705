"""Flash-attention forward (grouped GQA/MQA): the LM serving prefill.

Replaces the JAX package's ``flash_attention_pallas``.  q is
``(B, Sq, H, D)``, k and v are ``(B, Sk, KH, D)`` with ``H % KH == 0``;
query head ``h`` attends with kv head ``h // (H // KH)`` (contiguous
groups), and the repeated K/V is never formed.  Scores are the f32 dot
product times ``1/sqrt(D)``; masked scores are -1e30 (keys at or past
Sk and, under ``causal``, ``kpos > qpos`` with both counted from 0, also
when Sq != Sk).  An online softmax runs over key tiles, p is rounded to
v's dtype before the PV product (which sums in f32), and the output is
``acc / max(l, 1e-20)`` in q's dtype.  Sq and Sk need not be multiples
of any tile.

``flash_attention`` launches the CUDA kernel (``csrc/flash_attention.cu``:
bf16 on the tensor cores, f32 on the CUDA cores) for CUDA tensors and
runs the plain version beside it for CPU tensors.
"""
from __future__ import annotations

import torch

from . import build

Tensor = torch.Tensor

LAUNCHES = build.LaunchCounter("flash_attention")
# each dtype's kernel tiles (BQ, BK of its namespace in
# csrc/flash_attention.cu): the key tiling decides where p is rounded, so
# hold a kernel against the plain version at the tiles of its dtype
TILES = {torch.float32: (64, 32), torch.bfloat16: (128, 64)}
HEAD_DIMS = (16, 32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)
NEG_INF = -1.0e30


def flash_attention_plain(q: Tensor, k: Tensor, v: Tensor, *,
                          causal: bool = True, q_block: int = 512,
                          k_block: int = 1024) -> Tensor:
    """The TPU kernel's function in plain PyTorch, tile by tile: the same
    ``q_block``/``k_block`` clipping, the same key-tile order per query
    tile, and the same skip of causal tiles that have no live key (all
    query tiles run together, as slices of one tensor)."""
    b, sq, h, d = q.shape
    _, sk, kh, _ = k.shape
    if h % kh:
        raise ValueError(f"H={h} is not a multiple of KH={kh}")
    rep = h // kh
    q_block = min(q_block, max(8, sq))
    k_block = min(k_block, max(8, sk))
    sq_p = -(-sq // q_block) * q_block
    sk_p = -(-sk // k_block) * k_block
    scale = 1.0 / (d ** 0.5)
    dev = q.device
    qf = torch.zeros((b, sq_p, h, d), dtype=torch.float32, device=dev)
    qf[:, :sq] = q
    qf = qf.reshape(b, sq_p, kh, rep, d).permute(0, 2, 3, 1, 4)
    kf = torch.zeros((b, sk_p, kh, d), dtype=torch.float32, device=dev)
    kf[:, :sk] = k
    kf = kf.permute(0, 2, 3, 1)                      # (b, kh, d, sk_p)
    vf = torch.zeros((b, sk_p, kh, d), dtype=v.dtype, device=dev)
    vf[:, :sk] = v
    vf = vf.permute(0, 2, 1, 3)                      # (b, kh, sk_p, d)
    m = torch.full((b, kh, rep, sq_p), NEG_INF, device=dev)
    l = torch.zeros((b, kh, rep, sq_p), device=dev)  # noqa: E741
    acc = torch.zeros((b, kh, rep, sq_p, d), device=dev)
    qpos = torch.arange(sq_p, device=dev)
    for k0 in range(0, sk_p, k_block):
        # a query tile is live unless its last row precedes this key tile
        r0 = (k0 // q_block) * q_block if causal else 0
        s = torch.matmul(qf[..., r0:, :],
                         kf[:, :, None, :, k0:k0 + k_block]) * scale
        kpos = torch.arange(k0, k0 + k_block, device=dev)
        mask = (kpos < sk)[None, :]
        if causal:
            mask = mask & (qpos[r0:, None] >= kpos[None, :])
        s = torch.where(mask, s, NEG_INF)
        m_prev = m[..., r0:]
        m_new = torch.maximum(m_prev, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        a = torch.exp(m_prev - m_new)
        l[..., r0:] = l[..., r0:] * a + p.sum(dim=-1)
        pv = torch.matmul(p.to(v.dtype).float(),
                          vf[:, :, None, k0:k0 + k_block].float())
        acc[..., r0:, :] = acc[..., r0:, :] * a[..., None] + pv
        m[..., r0:] = m_new
    out = acc / torch.clamp_min(l, 1e-20)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq_p, h, d)[:, :sq]
    return out.to(q.dtype)


def flash_attention_cuda(q: Tensor, k: Tensor, v: Tensor, *,
                         causal: bool = True) -> Tensor:
    """Launch the CUDA kernel.  Raises on any operand it does not take:
    another device or dtype, a last dimension that is not contiguous, a
    head width outside HEAD_DIMS, or shapes that disagree; bf16 operands
    also need 16-byte aligned rows (the kernel copies 16 bytes at a
    time): a data pointer at a multiple of 16 bytes and strides that are
    multiples of 8 elements."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError("flash_attention_cuda needs CUDA tensors")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
        if t.dtype != q.dtype or t.dtype not in DTYPES:
            raise ValueError(f"q, k and v must all be f32 or all bf16, got "
                             f"{q.dtype}, {k.dtype}, {v.dtype}")
        if t.dim() != 4:
            raise ValueError(f"{name} must be 4-D, got {tuple(t.shape)}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s last dimension must be contiguous")
        if max(t.stride()) >= 2 ** 31:
            raise ValueError(f"{name}'s strides exceed 32 bits")
        if t.dtype == torch.bfloat16 and (
                t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3])):
            raise ValueError(f"bf16 {name} needs a 16-byte aligned start "
                             f"and strides that are multiples of 8, got "
                             f"{t.stride()}")
    b, sq, h, d = q.shape
    _, sk, kh, _ = k.shape
    if k.shape != (b, sk, kh, d) or v.shape != k.shape or kh == 0 \
            or h % kh:
        raise ValueError(f"shapes disagree: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head width {d} is not one of {HEAD_DIMS}")
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=dev)
    if b == 0 or sq == 0 or h == 0:
        return out
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = build.lib("flash_attention").flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, sq, sk, h, kh, d, *q.stride()[:3], *k.stride()[:3],
        *v.stride()[:3], int(causal), int(q.dtype == torch.bfloat16),
        stream)
    build.check_launch(err, "flash_attention")
    LAUNCHES.add()
    return out


def flash_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
                    q_block: int = 512, k_block: int = 1024) -> Tensor:
    """The kernel for CUDA tensors (at its own tiles), the plain version
    at ``q_block``/``k_block`` for CPU tensors."""
    if q.is_cuda:
        return flash_attention_cuda(q, k, v, causal=causal)
    if q.device.type != "cpu":
        raise ValueError(f"unsupported device {q.device}")
    return flash_attention_plain(q, k, v, causal=causal, q_block=q_block,
                                 k_block=k_block)
