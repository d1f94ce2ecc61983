"""Importing this package registers the port's configs: ``chords-dit-xl``
(reduced: ``chords-dit-micro``) and ``zamba2-2.7b`` (reduced:
``zamba2-2.7b-reduced``)."""
from repro_torch.configs.base import (ModelConfig, get_config,  # noqa: F401
                                      list_archs)
from repro_torch.configs import chords_dit, zamba2_2_7b  # noqa: F401
