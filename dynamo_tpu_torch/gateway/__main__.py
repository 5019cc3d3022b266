from dynamo_tpu_torch.gateway.epp import main

if __name__ == "__main__":
    raise SystemExit(main())
