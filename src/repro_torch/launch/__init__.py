"""Command-line entry points of the port (serving, training, the mesh) and
its launch tools: the dry run (:mod:`.dryrun_lib`, :mod:`.dryrun`), the
roofline (:mod:`.roofline`), the perf variants (:mod:`.perf`) and the
per-operation breakdown (:mod:`.hlo_breakdown`)."""
