from gcn_tpu_torch.data.registry import GraphData, get_dataset

__all__ = ["GraphData", "get_dataset"]
