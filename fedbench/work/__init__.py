"""The work a kernel's call must do, from its shapes alone: one module a
kernel, ``fedbench/work/<kernel>.py``, each with ``work(**shape) ->
{"flops": ..., "bytes": ...}``.  Each input byte is counted read once and
each output byte written once, whatever a kernel reads again; a
roofline's least time is the larger of flops over the peak rate and bytes
over the HBM bandwidth (``fedbench/peaks.json``)."""
