"""The plain reference that decides ``correct``, written from Line3D++'s
formulas in float64 (NumPy and PyTorch on any device) and sharing no code
with the program: ``options`` (Line3D++'s defaults), ``scene`` (the
segments, cameras, neighbours and fundamental matrices of a scene),
``step`` (matching, scoring, filtering, affinities), ``recon``
(collinearity, diffusion, clustering, fitting, sweep) and ``bundle``
(line bundling).

It checks the program stage by stage: the step from the scene's inputs,
and the reconstruction from the step's outputs that the program produced
(``reference_run``)."""
