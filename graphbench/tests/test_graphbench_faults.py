"""A run with the timed path broken underneath comes out not correct:
a flush that leaves the state unchanged, half of each batch left out, a
read or a job's answer altered where it is produced, a job that returns
its last result again.  (One card: no exchange between chips to leave
out.)"""
import pytest
import torch

from graphbench.tests import tiny
from repro_torch.stream.service import GraphService


def unchanged(mp):
    flush = GraphService.flush

    def broken(self):
        snap = self._snap
        report = flush(self)
        self._snap = snap
        return report
    mp.setattr(GraphService, "flush", broken)


def half_batch(mp):
    apply = GraphService.apply

    def broken(self, src, dst, w=None, op=None, valid=None):
        n = src.shape[0] // 2
        return apply(self, src[:n], dst[:n], w[:n], op[:n])
    mp.setattr(GraphService, "apply", broken)


def altered_read(mp):
    query = GraphService.query_edges

    def broken(self, qsrc, qdst):
        found, w = query(self, qsrc, qdst)
        found = found.clone()
        found[0] = ~found[0]
        return found, w
    mp.setattr(GraphService, "query_edges", broken)


def altered_job(mp):
    analytics = GraphService.analytics

    def broken(self, name, source=None, **kw):
        out = analytics(self, name, source, **kw).clone()
        vals = out.double()
        i = int(torch.argmax(torch.where(torch.isfinite(vals), vals,
                                         torch.tensor(-1.0).double())))
        out[i] = out[i] * 2 + 1
        return out
    mp.setattr(GraphService, "analytics", broken)


def stale_job(mp):
    analytics = GraphService.analytics
    kept = {}

    def broken(self, name, source=None, **kw):
        out = analytics(self, name, source, **kw)
        return kept.setdefault(name, out)
    mp.setattr(GraphService, "analytics", broken)


FAULTS = [(f, t) for f in (unchanged, half_batch, altered_read)
          for t in tiny.TRAFFIC]
FAULTS += [(f, t) for f in (altered_job, stale_job)
           for t in tiny.TRAFFIC if t != "update"]


@pytest.mark.parametrize("fault,traffic", FAULTS,
                         ids=[f"{f.__name__}-{t}" for f, t in FAULTS])
def test_fault_is_not_correct(fault, traffic, monkeypatch):
    fault(monkeypatch)
    line = tiny.run(traffic)
    assert not line["correct"], line["checks"]
