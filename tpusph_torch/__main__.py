from tpusph_torch.cli import main

raise SystemExit(main())
