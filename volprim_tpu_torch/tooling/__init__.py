"""Research tooling (volprim_tpu.tooling): SH fitting, the TV regularizer,
EnergyPMF, dataset generation, the radiance cache and radiosity loss,
remeshing and the headless visualizer."""

from . import dataset, energy_pmf, radiance_cache, regularizer, remesh, sh_fit, visualizer

__all__ = ["dataset", "energy_pmf", "radiance_cache", "regularizer", "remesh", "sh_fit",
           "visualizer"]
