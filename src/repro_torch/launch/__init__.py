# Launchers: ``python -m repro_torch.launch.serve`` (continuous-batching
# serving on the card) and the analytical FLOPs model behind its pricing.
