"""Data pipeline of the port (``repro.data``): counter-based synthetic
token streams and packed token files, sharded by host."""
from repro_torch.data.pipeline import (DataPipeline, MemmapSource,  # noqa: F401
                                       SyntheticSource, write_corpus)
