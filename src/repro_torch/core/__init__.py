"""CHORDS core (port of ``repro.core``): scheduler index math, init
sequences, the PF-ODE helpers, rectification, the Euler and Heun solvers,
Algorithm 1 with its heterogeneous lanes, the paper's baselines
(ParaDiGMS, SRDS) and the reward surrogate."""
from repro_torch.core import scheduler  # noqa: F401
from repro_torch.core.baselines import (BaselineResult,  # noqa: F401
                                        paradigms_sample, srds_sample)
from repro_torch.core.chords import (ChordsCarry, ChordsResult,  # noqa: F401
                                     LaneSpec, LaneState, accept_from_sums,
                                     accept_test, bmask, chords_init_carry,
                                     chords_sample, default_lane_profile,
                                     gather_slots, lane_init_state,
                                     make_round_body, make_slot_round_body,
                                     reset_lanes, reset_slots, select_output,
                                     slot_init_carry)
from repro_torch.core.init_sequence import (make_sequence,  # noqa: F401
                                            speedup_of, theorem_sequence)
from repro_torch.core.ode import (GaussianMixture, exponential_drift,  # noqa: F401
                                  uniform_tgrid)
from repro_torch.core.rectify import (coarse_smooth,  # noqa: F401
                                      downsample_latent, rectified_step,
                                      rectify_delta, upsample_latent)
from repro_torch.core.reward import reward, speedup_cont  # noqa: F401
from repro_torch.core.solvers import (draft_drift, nfe_per_step,  # noqa: F401
                                      sequential_sample)
