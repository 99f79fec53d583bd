"""The DQN and ADFLL system configs (copies of the reference's)."""
