from .shard import apply_params, render_loss

__all__ = ["apply_params", "render_loss"]
