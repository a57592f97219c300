"""Driver pre-processing a job (operators, media and sources to the device, the output's
datasets): the ``pre-processing_phase_execution_time`` that the program writes onto every
output (`PhaseTimers` via `write_run_info`), averaged over the window's jobs, in ms."""


def read(ctx):
    values = [j.attrs["pre-processing_phase_execution_time"] for j in ctx.jobs
              if "pre-processing_phase_execution_time" in j.attrs]
    return 1e3 * sum(values) / len(values) if values else None
