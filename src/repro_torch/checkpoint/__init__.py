from .npz import load_checkpoint, save_checkpoint, tree_to_flat_dict

__all__ = ["load_checkpoint", "save_checkpoint", "tree_to_flat_dict"]
