"""Run-time utilities of the port: logging, phase timing, run metadata."""

from kwave_tpu_torch.utils.observability import Logger, PhaseTimers, write_run_info

__all__ = ["Logger", "PhaseTimers", "write_run_info"]
