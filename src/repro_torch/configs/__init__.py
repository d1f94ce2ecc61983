"""Importing this package registers the port's configs (``chords-dit-xl``
and its reduced ``chords-dit-micro``)."""
from repro_torch.configs.base import (ModelConfig, get_config,  # noqa: F401
                                      list_archs)
from repro_torch.configs import chords_dit  # noqa: F401
