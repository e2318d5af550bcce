"""Dataset preparation (``python -m mg_gcn_tpu_torch.data.prep``)."""
