from repro_torch.models.api import Model, build_model, make_batch, params_from_numpy

__all__ = ["Model", "build_model", "make_batch", "params_from_numpy"]
