"""repro_torch.serve — batched multi-tenant request frontend over
repro_torch.stream.

Request batching hides per-request dispatch latency the way coroutine
prefetch hides per-block fetch latency, and the read-your-writes overlay
hides flush latency behind versioned reads.

    from repro_torch.serve import PointRead, ServeFrontend, UpdateBatch
    front = ServeFrontend(service)                 # a stream.GraphService
    front.register_tenant("fraud", read_your_writes=True)
    t = front.submit(PointRead(qsrc=qs, qdst=qd, tenant="fraud",
                               latency_class="interactive"))
    front.submit(UpdateBatch(src=us, dst=ud, tenant="fraud"))
    front.drain()                                  # or step() from a loop
    t.value["found"], t.value["w"], t.version
    front.report()                                 # QPS / p50 / p99 / occupancy
"""
from repro_torch.core.tuner import ServePlan, choose_serve_plan
from repro_torch.serve.admission import (ADMIT, DEFER, SHED,
                                         AdmissionController, TokenBucket)
from repro_torch.serve.batcher import (JitShapeStat, KindQueue, MicroBatch,
                                       bucket_for)
from repro_torch.serve.overlay import overlay_degrees, overlay_point_reads
from repro_torch.serve.replica import ReadPlane
from repro_torch.serve.request import (KINDS, LATENCY_CLASSES, READ_KINDS,
                                       Analytics, DegreeRead, KHopSample,
                                       PointRead, Request, Ticket,
                                       UpdateBatch)
from repro_torch.serve.scheduler import (ManualClock, ServeFrontend,
                                         TenantConfig)
