"""The plain reference: the k-space solver in PyTorch (`kspace`), the codec's
specification (`codec`, a frozen copy), an HDF5 reader (`h5read`, a frozen copy), the
inputs made from a seed (`recipe`, one module a configuration beside it) and the
comparisons (`compare`). Nothing here imports the program."""
