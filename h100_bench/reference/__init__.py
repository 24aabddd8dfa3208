"""The plain PyTorch reference of each driver (one module per driver), on
the frozen copy of the port's plain paths in `frozen/`."""
