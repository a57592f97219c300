"""The driver's window loop a step: the ``simulation_phase_execution_time`` that the
program writes onto every output, summed over the window's jobs, over their steps, in
ms."""


def read(ctx):
    values = [j.attrs["simulation_phase_execution_time"] for j in ctx.jobs
              if "simulation_phase_execution_time" in j.attrs]
    return 1e3 * sum(values) / (len(values) * ctx.cell.steps) if values else None
