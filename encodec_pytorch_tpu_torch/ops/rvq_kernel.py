"""RVQ nearest-code cascade: the CUDA kernel K1 (``csrc/rvq.cu``) and its plain
version.

Port of ``encodec_pytorch_tpu/ops/pallas_vq.py``. Both functions take the
latents ``x [M, D]`` (or ``[B, T, D]``) and the stage codebooks
``embed [K, N, D]``, run the greedy cascade over all K stages (score
``2·r·E_kᵀ − ‖E_k‖²``, first maximum wins, ``r −= E_k[idx]``) and return
``codes [K, M]`` (or ``[K, B, T]``) int32. :func:`rvq_encode` also takes
``esq``, the codebooks' squared norms ``[K, N]``, from a caller that caches
it; the plain version computes its own.

:func:`rvq_encode` launches the kernel for a CUDA tensor, all K stages in one
launch of a thread-block cluster that splits each stage's bins, and runs the
plain version only for a CPU tensor. The TPU kernel's ``MAX_GROUP`` stage
grouping and ``TILE_M`` row padding were VMEM and tiling rules and are not
carried over.
"""

import ctypes
from typing import Dict, Optional

import torch

from . import _build


def codebook_sq_norms(embed: torch.Tensor) -> torch.Tensor:
    """``‖E_k[n]‖²`` per stage and bin, ``[K, N]`` f32."""
    return torch.sum(torch.square(embed), dim=-1)


def rvq_encode_reference(x: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch cascade: a loop over stages of matmul, argmax, gather."""
    residual = x
    esq = codebook_sq_norms(embed)
    codes = []
    for k in range(embed.shape[0]):
        scores = 2.0 * torch.matmul(residual, embed[k].t()) - esq[k][None, :]
        idx = torch.argmax(scores, dim=-1)
        residual = residual - embed[k][idx]
        codes.append(idx)
    if not codes:
        return torch.zeros(0, x.shape[0], dtype=torch.int32, device=x.device)
    return torch.stack(codes).to(torch.int32)


def launch_config(M: int, N: int) -> Dict[str, int]:
    """The launch K1 makes for ``M`` rows and ``N`` bins: the cluster size,
    the rows of a tile and the bins of one shared buffer."""
    out = [ctypes.c_int() for _ in range(3)]
    _build.load().encodec_rvq_config(M, N, *(ctypes.byref(v) for v in out))
    return dict(zip(('cluster', 'rows_per_tile', 'bins_per_buffer'), (v.value for v in out)))


def _refuse(x: torch.Tensor, embed: torch.Tensor, esq: Optional[torch.Tensor]) -> None:
    """Raise the reason a CUDA call of :func:`rvq_encode` is refused."""
    if x.device.type != 'cuda' or embed.device != x.device:
        raise ValueError(f'rvq_encode: tensors on {x.device} and {embed.device}; '
                         'both must be on one CUDA device (or both on the CPU)')
    if x.dtype != torch.float32 or embed.dtype != torch.float32:
        raise TypeError(f'rvq_encode: float32 only, got {x.dtype} and {embed.dtype}')
    if x.dim() not in (2, 3) or embed.dim() != 3 or embed.shape[2] != x.shape[-1]:
        raise ValueError(f'rvq_encode: shapes x {tuple(x.shape)} and embed '
                         f'{tuple(embed.shape)} do not make [M, D] or [B, T, D], and [K, N, D]')
    if not embed.is_contiguous():
        raise ValueError('rvq_encode: the codebooks must be contiguous')
    raise ValueError(f'rvq_encode: esq {tuple(esq.shape)} {esq.dtype} on {esq.device} is '
                     f'not a contiguous float32 [K, N] = {tuple(embed.shape[:2])} beside the '
                     'codebooks')


def rvq_encode(x: torch.Tensor, embed: torch.Tensor,
               esq: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``codes [K, M]`` (``[K, B, T]`` for ``x [B, T, D]``) int32 of the
    greedy cascade; kernel K1 on CUDA. ``x`` may have any strides."""
    if x.is_cpu and embed.is_cpu:
        lead = x.shape[:-1]
        codes = rvq_encode_reference(x.reshape(-1, x.shape[-1]).contiguous(), embed)
        return codes.reshape(codes.shape[0], *lead)
    if esq is None and embed.is_cuda:
        esq = codebook_sq_norms(embed)
    # one cheap test of everything the kernel needs; _refuse says what failed
    device = x.get_device()
    if not (device >= 0 and embed.get_device() == device and esq.get_device() == device
            and x.dtype is torch.float32 and embed.dtype is torch.float32
            and esq.dtype is torch.float32 and x.dim() in (2, 3) and embed.dim() == 3
            and embed.shape[2] == x.shape[-1] and esq.shape == embed.shape[:2]
            and embed.is_contiguous() and esq.is_contiguous()):
        _refuse(x, embed, esq)
    K, N, D = embed.shape
    if x.dim() == 2:
        T = x.shape[0]
        sb, (st, sd) = 0, x.stride()
        M = T
    else:
        B, T, _ = x.shape
        sb, st, sd = x.stride()
        M = B * T
    codes = torch.empty((K, *x.shape[:-1]), device=x.device, dtype=torch.int32)
    rc = _build.load().encodec_rvq_encode_f32(
        x.data_ptr(), sb, st, sd, T, embed.data_ptr(), esq.data_ptr(), codes.data_ptr(),
        M, K, N, D, device, ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream))
    _build.check(rc, 'rvq_encode kernel')
    rvq_encode.launches += 1
    return codes


rvq_encode.launches = 0
