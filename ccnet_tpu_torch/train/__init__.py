from ccnet_tpu_torch.train.optim import make_optimizer, poly_lambda
from ccnet_tpu_torch.train.state import TrainState, create_train_state
from ccnet_tpu_torch.train.step import make_train_step

__all__ = [
    "TrainState",
    "create_train_state",
    "make_optimizer",
    "make_train_step",
    "poly_lambda",
]
