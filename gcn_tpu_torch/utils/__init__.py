from gcn_tpu_torch.utils.device import resolve_device
from gcn_tpu_torch.utils.timers import Timer, Timers

__all__ = ["resolve_device", "Timer", "Timers"]
