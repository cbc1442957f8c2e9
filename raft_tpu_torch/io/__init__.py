from raft_tpu_torch.io.schema import cases_as_dicts, get_from_dict, load_design

__all__ = ["cases_as_dicts", "get_from_dict", "load_design"]
