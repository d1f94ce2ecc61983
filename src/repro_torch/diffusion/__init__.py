from repro_torch.diffusion.schedules import RectifiedFlow, VPCosine  # noqa: F401
from repro_torch.diffusion.wrapper import (denoise, diffusion_loss,  # noqa: F401
                                           diffusion_loss_from, init_wrapper,
                                           make_drift, out_project, row_product,
                                           time_embedding, wrapper_specs)
