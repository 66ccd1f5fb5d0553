"""ROI preprocessing, assets, dataset refs and splits, IO and the PNG
codec, the eval decoder, synthetic fixtures."""
