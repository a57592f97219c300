"""Worked examples of the port (run each as ``python -m kwave_tpu_torch.examples.<name>``)."""
