"""The GPT-2-class policy, its value head and the sampler."""
