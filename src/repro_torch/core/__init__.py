"""CHORDS core (port of ``repro.core``): scheduler index math, init
sequences, the PF-ODE helpers, rectification, the Euler solver and the
homogeneous Algorithm 1."""
from repro_torch.core import scheduler  # noqa: F401
from repro_torch.core.chords import (ChordsCarry, ChordsResult,  # noqa: F401
                                     accept_from_sums, accept_test, bmask,
                                     chords_init_carry, chords_sample,
                                     make_round_body, make_slot_round_body,
                                     reset_slots, select_output,
                                     slot_init_carry)
from repro_torch.core.init_sequence import (make_sequence,  # noqa: F401
                                            speedup_of, theorem_sequence)
from repro_torch.core.ode import (GaussianMixture, exponential_drift,  # noqa: F401
                                  uniform_tgrid)
from repro_torch.core.rectify import rectified_step, rectify_delta  # noqa: F401
from repro_torch.core.solvers import sequential_sample  # noqa: F401
