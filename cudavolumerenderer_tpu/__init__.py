"""cudavolumerenderer_tpu — a differentiable volumetric path tracer in JAX.

Brand-new JAX/XLA implementation of the capabilities of the
reference CUDA renderer (Fe0437/CudaVolumeRenderer): Woodcock-tracking
free-flight sampling through heterogeneous density/albedo grids, HG phase
scattering, a GGX rough-dielectric medium boundary, progressive tiled
Monte-Carlo accumulation, and the reference's family of GPU work-scheduling
strategies re-expressed as wavefront array programs.
"""

__version__ = "0.1.0"
