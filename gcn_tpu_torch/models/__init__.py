from gcn_tpu_torch.models.gcn import GCN

__all__ = ["GCN"]
