"""xrt_device_paced: :mod:`xrt`, in the cells whose device paces the loop:
their runs spread little, so this rate holds a bound of its own."""

from benchmark.metrics.xrt import read  # noqa: F401
