from .atlas_losses import (alpha_bootstrap_loss, alpha_flow_loss, flow_loss,
                           gradient_loss, masked_mean, rgb_loss,
                           rigidity_loss, safe_norm, sparsity_loss)

__all__ = ["safe_norm", "rgb_loss", "gradient_loss", "rigidity_loss",
           "flow_loss", "sparsity_loss", "alpha_bootstrap_loss",
           "alpha_flow_loss", "masked_mean"]
