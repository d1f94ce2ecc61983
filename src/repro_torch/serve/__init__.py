"""CHORDS serving (port of ``repro.serve``): streaming sampler, static and
continuous engines, the round executor and the scheduling layer, and the
LM steps (prefill, KV-cache decode, greedy generation)."""
from repro_torch.serve.engine import (ChordsEngine,  # noqa: F401
                                      ContinuousEngine, Request, SampleOut,
                                      StreamingSampler)
from repro_torch.serve.executor import (GridSpec, RoundExecutor,  # noqa: F401
                                        SlotState, StreamSpec)
from repro_torch.serve.steps import (greedy_generate,  # noqa: F401
                                     make_decode_step, make_prefill)
