"""ERBs, replay, hubs, network, scheduler and the ADFLL system."""
