"""Scheduling layer of the port's serve engine — copies of
``repro.serve.sched`` (queue, cost model, FIFO/EDF/EDF-preempt policies)."""
from repro_torch.serve.sched.cost import CostModel  # noqa: F401
from repro_torch.serve.sched.policy import (Admission, Decision,  # noqa: F401
                                            EdfPolicy, EdfPreemptPolicy,
                                            EngineView, FifoPolicy, LaneView,
                                            POLICIES, Policy, get_policy)
from repro_torch.serve.sched.queue import AdmissionQueue, QueueItem  # noqa: F401
