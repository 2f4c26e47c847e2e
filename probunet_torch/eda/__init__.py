"""Exploratory data analysis of the ClimEx domain — ``probunet_tpu/eda``."""

from probunet_torch.eda.climex_eda import ClimexEDA, spearman_corr  # noqa: F401
