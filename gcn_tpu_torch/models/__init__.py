from gcn_tpu_torch.models.deepergcn import DeeperGCN
from gcn_tpu_torch.models.gat import GAT
from gcn_tpu_torch.models.gcn import GCN
from gcn_tpu_torch.models.hgnn import HGNN

__all__ = ["DeeperGCN", "GAT", "GCN", "HGNN"]
