"""Engine: session state, refresh (Lua -> window program), render, playback."""
