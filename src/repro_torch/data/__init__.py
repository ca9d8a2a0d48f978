from repro_torch.data.pipeline import SyntheticLMData
