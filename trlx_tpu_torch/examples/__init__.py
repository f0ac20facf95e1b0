"""Runnable examples of the port (the randomwalks task and its SFT and
PPO runners), with the learning-curve writer they share."""
