"""The operations and bytes that each kernel's work needs on a scene's
inputs, counted by the benchmark from the reference's step inputs and
scored slots: the same whatever implements the kernel.  One module per
kernel, each with ``count(x) -> (operations, bytes)``, where ``x`` is the
dict of ``reference_run.run``'s counts."""
