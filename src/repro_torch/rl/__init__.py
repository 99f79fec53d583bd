"""DQN, landmark environment, fleet engine and agent."""
