from repro_torch.optim.sgd import (adamw_init, adamw_update, make_optimizer,
                                   sgd_init, sgd_update)

__all__ = ["adamw_init", "adamw_update", "make_optimizer", "sgd_init",
           "sgd_update"]
