"""Plots of the port: BEV detections, feature maps, the feature gap
between modalities and the paper's figures. matplotlib and scikit-learn
are imported inside the functions that draw."""
