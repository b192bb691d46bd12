from spydrpick_jax.cli import main

raise SystemExit(main())
