"""CHORDS serving (port of ``repro.serve``): streaming sampler, static and
continuous engines, the round executor and the scheduling layer."""
from repro_torch.serve.engine import (ChordsEngine,  # noqa: F401
                                      ContinuousEngine, Request, SampleOut,
                                      StreamingSampler)
from repro_torch.serve.executor import (GridSpec, RoundExecutor,  # noqa: F401
                                        SlotState, StreamSpec)
