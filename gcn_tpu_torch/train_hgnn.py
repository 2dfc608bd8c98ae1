"""Command-line HGNN training of the port, the counterpart of
examples/train_hgnn.py (pyhgnn/train.py).

Usage:
    python -m gcn_tpu_torch.train_hgnn [--config PATH] [--dataset NAME] \
        [--epochs N] [--synthetic] [--synthetic-n N] [--factored] \
        [--device cuda|cpu]

Reads the YAML config (``gcn_tpu_torch/configs/hgnn.yaml``, which needs
PyYAML), loads the ModelNet40/NTU2012 ``.mat`` visual features, builds the
KNN hypergraph G = Dv^-1/2 H W De^-1 H^T Dv^-1/2 (``--factored``: its two
sparse factors, applied as a ``TwoHopAdj``) and trains the two-layer HGNN
with MultiStepLR and best-val selection. Without the ``.mat`` file, or with
``--synthetic``, a synthetic feature cloud of the same shape stands in
(``data.synthetic.synthetic_visual_features``, KNN on its first 64
columns). Prints the dataset line, the timing report and
``HGNN test accuracy: …``; exits 0 when that accuracy is above 0.5. Runs on
the card unless ``--device cpu`` is given.
"""

import argparse
import os
import sys
import time

import numpy as np


def main(argv=None):
    from gcn_tpu_torch.utils.config import CONFIG_DIR

    ap = argparse.ArgumentParser(description="Train a 2-layer HGNN "
                                             "(PyTorch)")
    ap.add_argument("--config", default=os.path.join(CONFIG_DIR,
                                                     "hgnn.yaml"))
    ap.add_argument("--dataset", default=None,
                    help="ModelNet40 | NTU2012 (default: config on_dataset)")
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--synthetic", action="store_true",
                    help="force the synthetic stand-in")
    ap.add_argument("--synthetic-n", type=int, default=800)
    ap.add_argument("--factored", action="store_true",
                    help="apply G as its two sparse factors (TwoHopAdj) "
                         "instead of the materialized chain")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    import torch

    from gcn_tpu_torch.graph.hypergraph import (construct_H_with_KNN,
                                                generate_G_factors,
                                                generate_G_from_H)
    from gcn_tpu_torch.models.hgnn import HGNN
    from gcn_tpu_torch.utils.config import get_config
    from gcn_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"torch device: {device} ({name})")
    cfg = get_config(args.config, make_dirs=False)
    dataset = args.dataset or cfg["on_dataset"]
    epochs = args.epochs if args.epochs is not None else cfg["max_epoch"]
    mat_path = os.path.expanduser(
        cfg["modelnet40_ft"] if dataset.lower() == "modelnet40"
        else cfg["ntu2012_ft"])

    t0 = time.time()
    if not args.synthetic and os.path.exists(mat_path):
        from gcn_tpu_torch.data.hypergraph_mat import (
            load_features_and_hypergraph)

        fts, labels, idx_train, idx_test, h = load_features_and_hypergraph(
            mat_path, m_prob=cfg["m_prob"], k_neigs=cfg["K_neigs"],
            is_prob_h=cfg["is_probH"],
            use_mvcnn_feature=cfg["use_mvcnn_feature"],
            use_gvcnn_feature=cfg["use_gvcnn_feature"],
            use_mvcnn_feature_for_structure=cfg[
                "use_mvcnn_feature_for_structure"],
            use_gvcnn_feature_for_structure=cfg[
                "use_gvcnn_feature_for_structure"])
    else:
        from gcn_tpu_torch.data.synthetic import synthetic_visual_features

        if not args.synthetic:
            print(f"[train_hgnn] {mat_path} not found; using the synthetic "
                  f"stand-in")
        fts, labels, idx_train, idx_test = synthetic_visual_features(
            n=args.synthetic_n)
        h = None
        for k in cfg["K_neigs"]:
            tmp = construct_H_with_KNN(fts[:, :64], k_neig=int(k),
                                       is_prob=cfg["is_probH"],
                                       m_prob=cfg["m_prob"])
            h = tmp if h is None else np.hstack([h, tmp])
        dataset = "synthetic"
    g = generate_G_factors(h) if args.factored else generate_G_from_H(h)
    n_class = int(labels.max()) + 1
    print(f"[{dataset}] n={fts.shape[0]} f={fts.shape[1]} classes={n_class} "
          f"hyperedges={h.shape[1]} (prepared in {time.time()-t0:.1f}s)")

    model = HGNN(in_ch=fts.shape[1], n_class=n_class, n_hid=cfg["n_hid"],
                 dropout=cfg["drop_out"], lr=cfg["lr"],
                 weight_decay=cfg["weight_decay"],
                 milestones=cfg["milestones"], gamma=cfg["gamma"],
                 device=device)
    model.fit(fts, g, labels, idx_train, idx_val=idx_test,
              num_epochs=epochs, verbose=True,
              print_freq=cfg.get("print_freq", 50))
    print(f"median epoch {model.median_epoch_ms:.3f} ms")
    print(model.timers.report())
    return model.test(idx_test)


if __name__ == "__main__":
    sys.exit(0 if main() > 0.5 else 1)
