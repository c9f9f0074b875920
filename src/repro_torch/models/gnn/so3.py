"""Real spherical-harmonic algebra for Equiformer-v2 / eSCN (l_max <= 6), as
``repro.models.gnn.so3``.

  * Wigner-D rotation matrices for the real SH basis by the e3nn J-matrix
    trick ``D(a, b, c) = Dz(a) . J . Dz(b) . J . Dz(c)``, with
    ``J = d(pi/2)`` computed once in float64 numpy from the complex
    Wigner-d formula (the port's own copy of the JAX module's numpy code:
    that module imports JAX);
  * the edge-alignment angles (edge direction to +z) behind the eSCN
    O(L^6) -> O(L^3) reduction (arXiv:2306.12059);
  * real spherical harmonics by rotating the +z harmonic.

J reaches a tensor's device as float32 once per (l, device).
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch


# ---------------------------------------------------------------------------
# complex Wigner-d and real-basis conversion (numpy, float64, once)
# ---------------------------------------------------------------------------

def _wigner_d_complex(l: int, beta: float) -> np.ndarray:
    """d^l_{m',m}(beta) by Wigner's explicit factorial sum (complex basis)."""
    d = np.zeros((2 * l + 1, 2 * l + 1))
    cb, sb = math.cos(beta / 2), math.sin(beta / 2)
    for i, mp in enumerate(range(-l, l + 1)):
        for j, m in enumerate(range(-l, l + 1)):
            pref = math.sqrt(math.factorial(l + mp) * math.factorial(l - mp)
                             * math.factorial(l + m) * math.factorial(l - m))
            s = 0.0
            for k in range(max(0, m - mp), min(l - mp, l + m) + 1):
                num = (-1.0) ** (mp - m + k)
                den = (math.factorial(l + m - k) * math.factorial(k)
                       * math.factorial(mp - m + k)
                       * math.factorial(l - mp - k))
                s += num / den * cb ** (2 * l + m - mp - 2 * k) \
                    * sb ** (mp - m + 2 * k)
            d[i, j] = pref * s
    return d


def _complex_to_real_U(l: int) -> np.ndarray:
    """Unitary map from the complex SH basis (m = -l..l, Condon-Shortley
    phase) to the real one."""
    n = 2 * l + 1
    U = np.zeros((n, n), complex)
    s2 = 1.0 / math.sqrt(2.0)
    for i, m in enumerate(range(-l, l + 1)):
        if m < 0:
            U[i, l + m] = 1j * s2
            U[i, l - m] = -1j * s2 * (-1) ** m
        elif m == 0:
            U[i, l] = 1.0
        else:
            U[i, l - m] = s2
            U[i, l + m] = s2 * (-1) ** m
    return U


def _z_rot_np(l: int, angle: float) -> np.ndarray:
    """numpy twin of :func:`z_rot_angles`."""
    n = 2 * l + 1
    m = np.arange(-l, l + 1)
    return np.cos(m * angle)[:, None] * np.eye(n) \
        - np.sin(m * angle)[:, None] * np.eye(n)[::-1]


@functools.lru_cache(maxsize=None)
def J_matrix(l: int) -> np.ndarray:
    """The e3nn-style involution J_l = D(R_pi about (y+z)/sqrt(2)), float64.

    J maps the z-axis to the y-axis and J^2 = I, so
    D(Ry(beta)) = J Dz(beta) J and the zyz Euler decomposition becomes
    D(a, b, c) = Dz(a) J Dz(b) J Dz(c).
    """
    d = _wigner_d_complex(l, math.pi / 2)
    U = _complex_to_real_U(l)
    Jy = U @ d @ U.conj().T                       # D(Ry(pi/2)), real
    if np.abs(Jy.imag).max() >= 1e-9:
        raise ArithmeticError(f"J_{l} is not real")
    Z = _z_rot_np(l, math.pi / 2)
    J = Z @ Jy.real @ Z
    if np.abs(J @ J - np.eye(2 * l + 1)).max() >= 1e-9:
        raise ArithmeticError(f"J_{l}^2 != I")
    return np.ascontiguousarray(J)


@functools.lru_cache(maxsize=None)
def _J_on(l: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(J_matrix(l), dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# rotations on tensors
# ---------------------------------------------------------------------------

def z_rot_angles(l: int, angle: torch.Tensor) -> torch.Tensor:
    """Dz(angle) for real SH of degree l: [..., 2l+1, 2l+1], basis order
    m = -l..l; row m holds cos(m a) on the diagonal and -sin(m a) on the
    antidiagonal (the vector-rep convention Y(R r) = D(R) Y(r))."""
    n = 2 * l + 1
    m = torch.arange(-l, l + 1, device=angle.device, dtype=angle.dtype)
    ang = angle[..., None] * m                                  # [..., n]
    eye = torch.eye(n, dtype=angle.dtype, device=angle.device)
    return torch.cos(ang)[..., :, None] * eye \
        - torch.sin(ang)[..., :, None] * eye.flip(0)


def wigner_D(l: int, alpha: torch.Tensor, beta: torch.Tensor,
             gamma: torch.Tensor) -> torch.Tensor:
    """Real Wigner-D^l(alpha, beta, gamma) = Dz(a) J Dz(b) J Dz(c)."""
    J = _J_on(l, alpha.device).to(alpha.dtype)
    Da = z_rot_angles(l, alpha)
    Db = z_rot_angles(l, beta)
    Dc = z_rot_angles(l, gamma)
    return Da @ (J @ (Db @ (J @ Dc)))


def edge_align_angles(vec: torch.Tensor):
    """Angles (alpha, beta) such that R(alpha, beta, 0) maps +z to
    vec/|vec|: rotate features by D(0, -beta, -alpha) to put the edge on
    +z, back with D(alpha, beta, 0)."""
    x, y, z = vec[..., 0], vec[..., 1], vec[..., 2]
    r = torch.sqrt(x * x + y * y + z * z) + 1e-12
    beta = torch.arccos(torch.clamp(z / r, -1.0, 1.0))
    alpha = torch.atan2(y, x)
    return alpha, beta


def rotate_to_edge(l: int, feats: torch.Tensor, alpha, beta) -> torch.Tensor:
    """feats [..., 2l+1, C] in the lab frame -> the edge frame (edge on
    +z)."""
    D = wigner_D(l, torch.zeros_like(alpha), -beta, -alpha)
    return D @ feats


def rotate_from_edge(l: int, feats: torch.Tensor, alpha,
                     beta) -> torch.Tensor:
    return wigner_D(l, alpha, beta, torch.zeros_like(alpha)) @ feats


def real_sph_harm(l_max: int, vec: torch.Tensor) -> torch.Tensor:
    """Y_lm stacked over (l, m) -> [..., (l_max+1)^2] (directions need not
    be unit): Y(R z) = D(R) Y(z), Y_l(z) the m = 0 unit vector scaled by
    sqrt((2l+1)/4pi), i.e. that column of D."""
    alpha, beta = edge_align_angles(vec)
    outs = []
    for l in range(l_max + 1):
        D = wigner_D(l, alpha, beta, torch.zeros_like(alpha))
        outs.append(D[..., :, l] * math.sqrt((2 * l + 1) / (4 * math.pi)))
    return torch.cat(outs, dim=-1)
