from gcn_tpu_torch.train.loop import TrainResult, fit_gcn
from gcn_tpu_torch.train.metrics import accuracy, masked_nll, micro_f1
from gcn_tpu_torch.train.optim import adam_l2

__all__ = ["TrainResult", "fit_gcn", "accuracy", "masked_nll", "micro_f1",
           "adam_l2"]
