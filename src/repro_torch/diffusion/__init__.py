from repro_torch.diffusion.wrapper import (denoise, init_wrapper,  # noqa: F401
                                           make_drift, time_embedding,
                                           wrapper_specs)
