"""Plotting — ``probunet_tpu/viz``; matplotlib is imported only when a
figure is drawn."""

from probunet_torch.viz.plots import plot_batch, plot_loss_curves, plot_sample_batch  # noqa: F401
