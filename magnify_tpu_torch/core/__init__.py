from magnify_tpu_torch.core.xd import DataArray, Dataset, Variable, concat

__all__ = ["DataArray", "Dataset", "Variable", "concat"]
