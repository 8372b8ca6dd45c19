"""The run's output: history, ParaView/Tecplot/CGNS plots, restarts, probes
and forces (copies of hifiles_tpu/io/ on the port's solvers)."""
