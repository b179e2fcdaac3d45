from repro_torch.optim.optimizers import (adafactor_init, adafactor_update,  # noqa: F401
                                          adamw_init, adamw_update,
                                          clip_by_global_norm, global_norm,
                                          make_optimizer)
from repro_torch.optim.schedules import cosine_schedule  # noqa: F401
