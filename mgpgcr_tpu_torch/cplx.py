"""Split re/im complex fields on PyTorch tensors.

Counterpart of ``mgpgcr_tpu/cplx.py``. A lattice field is a ``CF`` pair of
two equally shaped real tensors, in the slab layout ``(4, 3, T, Z, Y*X)``
with the site index fastest: neighbouring CUDA threads then read
neighbouring addresses, the hand-written kernels take the two planes as
plain ``float*`` pointers, and every intermediate compares array for array
with the JAX reference.

Scalars (inner products, GCR coefficients, the hopping parameter k) are
0-d or small 1-d *complex* tensors: PyTorch has complex dtypes, and
``torch.view_as_real`` hands a kernel the (re, im) pair of a complex
scalar as a pointer to two floats that stay on the device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """The device of an entry point: CUDA unless the caller names another.

    Raises when CUDA is asked for (explicitly or by default) and there is
    none, so that nothing silently runs the plain versions on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU"
        )
    return dev


def complex_dtype(real_dtype: torch.dtype) -> torch.dtype:
    """The complex dtype whose parts are ``real_dtype`` (bf16 -> c64)."""
    return torch.complex128 if real_dtype == torch.float64 else torch.complex64


@dataclasses.dataclass(frozen=True)
class CF:
    """Complex tensor as two equally shaped real tensors."""

    re: torch.Tensor
    im: torch.Tensor

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.re.shape)

    @property
    def ndim(self) -> int:
        return self.re.ndim

    @property
    def dtype(self) -> torch.dtype:
        """The *real* component dtype."""
        return self.re.dtype

    @property
    def device(self) -> torch.device:
        return self.re.device

    def reshape(self, *shape) -> "CF":
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return CF(self.re.reshape(shape), self.im.reshape(shape))

    def astype(self, dtype) -> "CF":
        return CF(self.re.to(dtype), self.im.to(dtype))

    def to(self, *args, **kwargs) -> "CF":
        return CF(self.re.to(*args, **kwargs), self.im.to(*args, **kwargs))

    def permute(self, *axes) -> "CF":
        if len(axes) == 1 and isinstance(axes[0], (tuple, list)):
            axes = tuple(axes[0])
        return CF(self.re.permute(axes), self.im.permute(axes))

    def contiguous(self) -> "CF":
        return CF(self.re.contiguous(), self.im.contiguous())

    def clone(self) -> "CF":
        return CF(self.re.clone(), self.im.clone())

    def conj(self) -> "CF":
        return CF(self.re, -self.im)

    def __getitem__(self, idx) -> "CF":
        return CF(self.re[idx], self.im[idx])

    def __setitem__(self, idx, value) -> None:
        """In-place write into both planes (the tensors are shared, so the
        frozen dataclass itself is unchanged)."""
        v = ascf(value)
        self.re[idx] = v.re
        self.im[idx] = v.im

    def __neg__(self) -> "CF":
        return CF(-self.re, -self.im)

    def __add__(self, other):
        if isinstance(other, CF):
            return CF(self.re + other.re, self.im + other.im)
        if _is_reallike(other):
            return CF(self.re + other, self.im)
        return NotImplemented

    __radd__ = __add__

    def __sub__(self, other):
        if isinstance(other, CF):
            return CF(self.re - other.re, self.im - other.im)
        if _is_reallike(other):
            return CF(self.re - other, self.im)
        return NotImplemented

    def __mul__(self, other):
        if isinstance(other, CF):
            return CF(
                self.re * other.re - self.im * other.im,
                self.re * other.im + self.im * other.re,
            )
        if _is_complexlike(other):
            cr, ci = other.real, other.imag
            return CF(self.re * cr - self.im * ci, self.re * ci + self.im * cr)
        if _is_reallike(other):
            return CF(self.re * other, self.im * other)
        return NotImplemented

    __rmul__ = __mul__


def _is_complexlike(x) -> bool:
    if isinstance(x, complex):
        return True
    return isinstance(x, torch.Tensor) and x.is_complex()


def _is_reallike(x) -> bool:
    if isinstance(x, (int, float)):
        return True
    return isinstance(x, torch.Tensor) and not x.is_complex()


def is_cf(x) -> bool:
    return isinstance(x, CF)


def ascf(x) -> CF:
    """Coerce a CF or a complex tensor to CF."""
    if isinstance(x, CF):
        return x
    if isinstance(x, torch.Tensor) and x.is_complex():
        return CF(x.real, x.imag)
    raise TypeError(f"cannot make a CF of {type(x).__name__}")


def from_numpy(z: np.ndarray, dtype=torch.float32, device=None) -> CF:
    """Host complex ndarray -> CF on ``device`` (CUDA unless named)."""
    dev = resolve_device(device)
    z = np.asarray(z)
    return CF(
        torch.as_tensor(np.ascontiguousarray(z.real)).to(dev, dtype),
        torch.as_tensor(np.ascontiguousarray(z.imag)).to(dev, dtype),
    )


def to_numpy(x) -> np.ndarray:
    """CF or tensor -> host ndarray (complex128 for CF)."""
    if isinstance(x, CF):
        re = x.re.detach().to("cpu", torch.float64).numpy()
        im = x.im.detach().to("cpu", torch.float64).numpy()
        return re + 1j * im
    return x.detach().cpu().numpy()


def scalar(z, like: CF) -> torch.Tensor:
    """A complex 0-d tensor of ``like``'s precision on ``like``'s device."""
    if isinstance(z, torch.Tensor):
        return z.to(like.device, complex_dtype(like.dtype))
    return torch.tensor(complex(z), dtype=complex_dtype(like.dtype), device=like.device)


def zeros_like(x: CF) -> CF:
    return CF(torch.zeros_like(x.re), torch.zeros_like(x.im))


def abs2(x: CF) -> torch.Tensor:
    """|x|^2 elementwise, real tensor."""
    return x.re * x.re + x.im * x.im


def abs2_sum(x: CF) -> torch.Tensor:
    """||x||^2 as a real 0-d tensor (Fields.h:229-235)."""
    return torch.sum(abs2(x))


def vdot(a: CF, b: CF) -> torch.Tensor:
    """<a, b> = sum conj(a) b as a complex 0-d tensor (Fields.h:217-226)."""
    return torch.complex(
        torch.sum(a.re * b.re + a.im * b.im),
        torch.sum(a.re * b.im - a.im * b.re),
    )


def scale_real(x: CF, s) -> CF:
    return CF(x.re * s, x.im * s)


def where(cond, a: CF, b: CF) -> CF:
    return CF(torch.where(cond, a.re, b.re), torch.where(cond, a.im, b.im))


def stack_zeros(n: int, like: CF) -> CF:
    """n zeroed copies-of-shape of ``like``: the GCR direction storage
    (GCR.h:207-210)."""
    shape = (n,) + like.shape
    return CF(
        torch.zeros(shape, dtype=like.dtype, device=like.device),
        torch.zeros(shape, dtype=like.dtype, device=like.device),
    )


def conj_contract_stack(stack: CF, v: CF) -> torch.Tensor:
    """beta_s = <stack_s, v> for all s: complex (S,) tensor (GCR.h:251-262
    batched). Reads each stack plane once."""
    s = stack.shape[0]
    sr, si = stack.re.reshape(s, -1), stack.im.reshape(s, -1)
    vr, vi = v.re.reshape(-1), v.im.reshape(-1)
    return torch.complex(sr @ vr + si @ vi, sr @ vi - si @ vr)


def weighted_stack_sum(coeffs: torch.Tensor, stack: CF) -> CF:
    """sum_s coeffs_s stack_s for complex (S,) coeffs (GCR.h:265-266)."""
    s = stack.shape[0]
    sr, si = stack.re.reshape(s, -1), stack.im.reshape(s, -1)
    cr = coeffs.real.to(stack.dtype)
    ci = coeffs.imag.to(stack.dtype)
    shape = stack.shape[1:]
    return CF((cr @ sr - ci @ si).reshape(shape), (cr @ si + ci @ sr).reshape(shape))


def roll(x: CF, shift: int, axis: int) -> CF:
    return CF(torch.roll(x.re, shift, axis), torch.roll(x.im, shift, axis))


def stack(xs, axis: int = 0) -> CF:
    return CF(
        torch.stack([x.re for x in xs], dim=axis),
        torch.stack([x.im for x in xs], dim=axis),
    )


def concatenate(xs, axis: int = 0) -> CF:
    return CF(
        torch.cat([x.re for x in xs], dim=axis),
        torch.cat([x.im for x in xs], dim=axis),
    )


def take(x: CF, indices, axis: int) -> CF:
    idx = torch.as_tensor(indices, device=x.device)
    return CF(
        torch.index_select(x.re, axis, idx), torch.index_select(x.im, axis, idx)
    )


def random(
    generator: torch.Generator, shape, dtype=torch.float32, device=None
) -> CF:
    """Random CF with re, im ~ U[-1, 1) (Field::init_rand, Fields.h:126-135),
    drawn from ``generator`` on ``device`` (CUDA unless named); the
    generator must live on that device."""
    dev = resolve_device(device)
    re = torch.rand(shape, generator=generator, dtype=dtype, device=dev)
    im = torch.rand(shape, generator=generator, dtype=dtype, device=dev)
    return CF(2.0 * re - 1.0, 2.0 * im - 1.0)
