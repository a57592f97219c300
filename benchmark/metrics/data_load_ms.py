"""Reading the input file a job (`cli.main`'s `read_input_file`): the
``data_loading_phase_execution_time`` that the program writes onto every output, averaged
over the window's jobs, in ms. Only a job that reads a file has one."""


def read(ctx):
    if ctx.cell.traffic["entry"] != "files":
        return None
    values = [j.attrs["data_loading_phase_execution_time"] for j in ctx.jobs
              if "data_loading_phase_execution_time" in j.attrs]
    return 1e3 * sum(values) / len(values) if values else None
