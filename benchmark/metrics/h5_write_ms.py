"""The program's HDF5 writer a job: host seconds inside `io.h5file`'s
``Dataset.__setitem__``, ``Group.create_dataset`` and ``File.close`` over the window
(`benchmark.codec_clock`), averaged over its jobs, in ms. Only a job that writes a file
has one."""


def read(ctx):
    if ctx.cell.traffic["entry"] != "files" or not ctx.jobs:
        return None
    return 1e3 * sum(j.h5_write_s for j in ctx.jobs) / len(ctx.jobs)
