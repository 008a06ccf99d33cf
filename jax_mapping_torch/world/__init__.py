"""The world store's config derivation (`store.window_slam_config`)."""
