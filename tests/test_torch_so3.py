"""The port's SO(3) algebra (``repro_torch.models.gnn.so3``) against
``repro.models.gnn.so3``: the float64 J matrices within 1e-12, Wigner-D
blocks, edge-alignment angles and real spherical harmonics within atol
1e-5 at seeded angles and vectors (float32 on both sides), and the port's
own orthogonality, l = 1 and +z alignment checks (the port's side of
tests/test_models_gnn.py's ``test_wigner_homomorphism_and_edge_alignment``).
"""
import torch_parity  # noqa: F401,E402  (first: one torch thread a worker)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.gnn import so3 as jso3
from repro_torch.models.gnn import so3

L_MAX = 6
ATOL = 1e-5


def rotmat(a, b, c):
    def Rz(t):
        return np.array([[np.cos(t), -np.sin(t), 0],
                         [np.sin(t), np.cos(t), 0], [0, 0, 1]])

    def Ry(t):
        return np.array([[np.cos(t), 0, np.sin(t)], [0, 1, 0],
                         [-np.sin(t), 0, np.cos(t)]])

    return Rz(a) @ Ry(b) @ Rz(c)


def _angles(seed, n=64):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-np.pi, np.pi, n).astype(np.float32),
            rng.uniform(0, np.pi, n).astype(np.float32),
            rng.uniform(-np.pi, np.pi, n).astype(np.float32)]


def _vectors(seed, n=64):
    v = np.random.default_rng(seed).standard_normal((n, 3)).astype(
        np.float32)
    v[:3] = [[0, 0, 2.0], [0, 0, -1.0], [1e-3, 0, 0]]    # the poles, tiny
    return v


@pytest.mark.parametrize("l", range(L_MAX + 1))
def test_J_matrix_matches_jax(l):
    J = so3.J_matrix(l)
    assert J.dtype == np.float64
    np.testing.assert_allclose(J, jso3.J_matrix(l), rtol=0, atol=1e-12)
    np.testing.assert_allclose(J @ J, np.eye(2 * l + 1), rtol=0, atol=1e-9)


@pytest.mark.parametrize("l", range(L_MAX + 1))
def test_wigner_D_matches_jax(l):
    a, b, c = _angles(l)
    got = so3.wigner_D(l, *map(torch.as_tensor, (a, b, c)))
    ref = jso3.wigner_D(l, *map(jnp.asarray, (a, b, c)))
    assert got.shape == (64, 2 * l + 1, 2 * l + 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=ATOL)
    feats = np.random.default_rng(l + 10).standard_normal(
        (64, 2 * l + 1, 5)).astype(np.float32)
    for fn, jfn in ((so3.rotate_to_edge, jso3.rotate_to_edge),
                    (so3.rotate_from_edge, jso3.rotate_from_edge)):
        np.testing.assert_allclose(
            fn(l, torch.as_tensor(feats), torch.as_tensor(a),
               torch.as_tensor(b)).numpy(),
            np.asarray(jfn(l, jnp.asarray(feats), jnp.asarray(a),
                           jnp.asarray(b))), rtol=0, atol=ATOL)
    np.testing.assert_allclose(
        so3.z_rot_angles(l, torch.as_tensor(a)).numpy(),
        np.asarray(jso3.z_rot_angles(l, jnp.asarray(a))), rtol=0, atol=ATOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_edge_angles_and_harmonics_match_jax(seed):
    v = _vectors(seed)
    al, be = so3.edge_align_angles(torch.as_tensor(v))
    jal, jbe = jso3.edge_align_angles(jnp.asarray(v))
    np.testing.assert_allclose(al.numpy(), np.asarray(jal), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(be.numpy(), np.asarray(jbe), rtol=0,
                               atol=ATOL)
    Y = so3.real_sph_harm(L_MAX, torch.as_tensor(v))
    assert Y.shape == (64, (L_MAX + 1) ** 2)
    np.testing.assert_allclose(
        Y.numpy(), np.asarray(jso3.real_sph_harm(L_MAX, jnp.asarray(v))),
        rtol=0, atol=ATOL)


def test_wigner_orthogonal_l1_and_edge_alignment():
    """D D^T = I at every degree; D^1 is the rotation matrix in the
    (y, z, x) basis; rotating Y(v) to the edge frame of v gives the +z
    harmonic."""
    a1, b1, c1 = (torch.tensor(t) for t in (0.3, 1.1, -0.7))
    for l in range(L_MAX + 1):
        D = so3.wigner_D(l, a1, b1, c1).numpy()
        np.testing.assert_allclose(D @ D.T, np.eye(2 * l + 1), atol=ATOL)
    P = np.zeros((3, 3))
    P[0, 1] = P[1, 2] = P[2, 0] = 1
    np.testing.assert_allclose(so3.wigner_D(1, a1, b1, c1).numpy(),
                               P @ rotmat(0.3, 1.1, -0.7) @ P.T, atol=ATOL)
    v = torch.tensor([0.3, -0.5, 0.8])
    Y = so3.real_sph_harm(4, v)
    al, be = so3.edge_align_angles(v)
    off = 0
    for l in range(5):
        n = 2 * l + 1
        y_edge = so3.rotate_to_edge(l, Y[off:off + n][:, None], al, be)[:, 0]
        yz = np.zeros(n)
        yz[l] = np.sqrt((2 * l + 1) / (4 * np.pi))
        np.testing.assert_allclose(y_edge.numpy(), yz, atol=ATOL)
        off += n
