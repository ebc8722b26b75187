"""Neural network models (the CREPE pitch CNN, the BUT/Phonexia
bottleneck MLPs) in PyTorch."""
