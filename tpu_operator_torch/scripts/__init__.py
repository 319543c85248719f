"""The port's operational scripts, counterparts of the repo's ``scripts/``:
``hbm_sweep.py`` (the triad over a size x iterations grid on the card),
``install.sh`` (install, upgrade and uninstall over ``gpuop-cfg``) and
``end-to-end.sh`` (the shell e2e tier)."""
