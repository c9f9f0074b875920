"""The port's CUDA kernels on the card: each against its plain version, and
a small GraphService sequence on the card against the same one on the host.
Every test is marked ``cuda`` and skips without a CUDA device; the file
imports no JAX, so it runs where only torch is installed:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("E,F,rows", [(100_000, 1, 5_000), (20_000, 16, 700),
                                      (5, 3, 9), (0, 1, 4)])
def test_segment_sum_kernel_matches_float64_sum(gen, E, F, rows):
    from repro_torch import backend
    from repro_torch.kernels import segment_matmul, segment_sum_ref
    data = torch.rand((E, F), generator=gen, device="cuda")
    seg = torch.randint(-1, rows + 1, (E,), generator=gen, device="cuda",
                        dtype=torch.int32)
    before = backend.LAUNCHES["segment_sum"]
    got = segment_matmul(data, seg, rows)
    assert backend.LAUNCHES["segment_sum"] == before + 1
    ref = segment_sum_ref(data.double(), seg, rows)
    torch.testing.assert_close(got.double(), ref, rtol=1e-5, atol=1e-6)
    assert torch.equal(got, segment_matmul(data, seg, rows))   # deterministic
    torch.cuda.synchronize()


@pytest.mark.parametrize("rows_per_step,F", [(1, 1), (4, 1), (1, 16), (2, 3)])
def test_block_gather_kernel_matches_index_select(gen, rows_per_step, F):
    from repro_torch.kernels import block_gather_ref, gather_rows
    groups = 5_000
    table = torch.rand((groups * rows_per_step, F), generator=gen,
                       device="cuda")
    ids = torch.randint(0, groups, (70_000,), generator=gen, device="cuda",
                        dtype=torch.int32)
    got = gather_rows(table, ids, rows_per_step=rows_per_step)
    assert torch.equal(got, block_gather_ref(table, ids, rows_per_step))
    torch.cuda.synchronize()


def test_service_on_the_card_matches_the_host(gen):
    import numpy as np

    from repro_torch import interop
    from repro_torch.data.synthetic import rmat_edges, update_stream
    from repro_torch.stream.service import GraphService
    src, dst = rmat_edges(500, 4000, seed=1, device="cpu")
    svcs = [GraphService.from_coo(src, dst, num_vertices=500, block_width=8,
                                  log_capacity=2048, device=d)
            for d in ("cuda", "cpu")]
    for s, d, w, op in update_stream(500, (src, dst), 600, 2, seed=2,
                                     device="cpu"):
        reps = []
        for svc in svcs:
            svc.apply(s, d, w, op)
            reps.append(svc.flush())
        assert reps[0] == reps[1]
        a, b = (interop.cbl_to_numpy(svc.snapshot.cbl) for svc in svcs)
        for k in b["store"]:
            np.testing.assert_array_equal(a["store"][k], b["store"][k])
        for k in ("v_deg", "v_level", "v_head", "v_tail"):
            np.testing.assert_array_equal(a[k], b[k])
    pr = [interop.to_numpy(svc.analytics("pagerank")) for svc in svcs]
    np.testing.assert_allclose(pr[0], pr[1], rtol=1e-5, atol=1e-8)
    for name in ("bfs", "cc"):
        out = [interop.to_numpy(svc.analytics(name)) for svc in svcs]
        np.testing.assert_array_equal(out[0], out[1])
