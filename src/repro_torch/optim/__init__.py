from repro_torch.optim.optimizer import (AdamWConfig, apply_updates,  # noqa: F401
                                         init_state, lr_at, state_axes)
